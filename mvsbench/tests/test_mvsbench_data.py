"""The harness is driven by data: every cell of ``BENCHMARK.json`` resolves
its configuration, traffic mix, limits, loop and per-layer readers by name;
names, units and texts keep to the contract's characters and lengths; and a
cell, a mix, a configuration or a metric added as new files needs no edit
to a file that is there."""

import json
import math
import os
import re
import shutil

import pytest

from mvsbench import harness

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["command"] == ["python3", "-m", "mvsbench.run"]
    assert SPEC["paths"] == ["mvsbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 x 90 s of compile a cell, 1200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    c = harness.resolve(cell, SPEC)
    assert c.config["model"] in ("adamvs", "msrednet")
    assert harness.loop_module(c.traffic["kind"]).run
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer and c.limits
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end" and not (group == "per_layer"
                                                                   and key == "source"):
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in SPEC["configs"]:
        assert c["file"].startswith("mvsbench/") and not c["reduced"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(len(SPEC["workloads"]) / 4))


def test_added_files_need_no_edit(tmp_path, monkeypatch):
    """A new configuration, mix, limits, cell and metric, each a new file
    plus an entry in BENCHMARK.json: resolved and read with every file that
    was there unchanged."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "mvsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (root / "mvsbench" / p).read_bytes()
              for p in (str(x.relative_to(root / "mvsbench"))
                        for x in (root / "mvsbench").rglob("*") if x.is_file())}
    bench = root / "mvsbench"
    cfg = json.loads((bench / "configs/adamvs.json").read_text())
    cfg["name"] = "adamvs_b4"
    (bench / "configs/adamvs_b4.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic/predict-fused-bf16.json").read_text())
    mix["feature_cache"] = 8
    (bench / "traffic/predict-cache.json").write_text(json.dumps(mix))
    (bench / "limits/adamvs_b4-predict-cache.json").write_text('{"depth_err": 1.0}')
    (bench / "metrics/cache_hit_share.py").write_text("def read(run):\n    return 50.0\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "adamvs_b4", "source": "x", "file": "mvsbench/configs/"
                            "adamvs_b4.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "adamvs_b4-predict-cache", "config": "adamvs_b4",
                              "traffic": "predict-cache", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "cache_hit_share", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "feature cache",
                              "moves": "maps_per_s", "workloads": ["adamvs_b4-predict-cache"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "BENCH", str(bench))
    cell = harness.resolve("adamvs_b4-predict-cache")
    assert cell.traffic["feature_cache"] == 8 and cell.limits == {"depth_err": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["cache_hit_share"]
    assert harness.read_per_layer(cell, None) == {"cache_hit_share": {"value": 50.0,
                                                                      "unit": "%"}}
    assert all((bench / p).read_bytes() == b for p, b in before.items())
