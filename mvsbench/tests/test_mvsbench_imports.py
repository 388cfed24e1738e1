"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the port: every module under ``mvsbench/``
(its tests left out) is parsed, and the top-level name of each import (the
part before the first dot) is compared whole with the forbidden ones, so
``adamvs_tpu_torch`` is not taken for ``adamvs_tpu``."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVERYWHERE = {"jax", "jaxlib", "flax", "adamvs_tpu"}
IN_REFERENCE = EVERYWHERE | {"adamvs_tpu_torch"}


def modules():
    for root, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), BENCH)


def top_level_imports(path: str) -> set:
    with open(os.path.join(BENCH, path)) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_modules_found():
    found = set(modules())
    assert {"run.py", "harness.py", "check.py", "reference/models.py"} <= found


@pytest.mark.parametrize("path", sorted(modules()))
def test_no_forbidden_import(path):
    forbidden = IN_REFERENCE if path.startswith("reference" + os.sep) else EVERYWHERE
    assert not top_level_imports(path) & forbidden


def test_names_compared_whole():
    tree_src = "import adamvs_tpu_torch.models\nfrom adamvs_tpu_torch import x\n"
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module
             for n in ast.parse(tree_src).body}
    assert names == {"adamvs_tpu_torch"} and not names & EVERYWHERE
