"""bf16 mixed-precision training with the port against the JAX package on the
CPU: float32 parameters, bf16 compute, as flax's ``dtype=bf16`` with its
default float32 ``param_dtype``.

- Every block and cell of ``nn/`` and both feature nets in bf16 with float32
  weights, forward and input and weight gradients, against the flax module
  with ``dtype=jnp.bfloat16``: relative L2 within 2e-2, weight gradients
  float32.
- One bf16 train step of each family in the scan form (the JAX CLI's
  default) against JAX ``value_and_grad`` with ``dtype=bf16``; the fused
  forms are in ``test_torch_port_bf16_train_fused.py``. A bf16 gradient is
  chaotic: multiplying every float32 weight by 1 + 2^-22 n (about 4 float32
  steps) moves JAX's bf16 gradient by ~0.4 relative L2 in AdaMVS's feature
  net, while its float32 gradient moves by ~1e-5. So each top-level module's
  gradient is held to JAX's within twice its noise: the largest distance
  over 3 such draws of JAX's step from its unjittered step. The conv biases
  are held apart: XLA:CPU sums the bias gradient of a bf16 conv (the
  transpose of the bias broadcast) in bf16, which moves JAX's bias
  gradients by up to ~0.3 relative L2 from float32 where the port's, summed
  in float32, stay within ~1e-2; so the port's conv-bias gradients are held
  to JAX's float32 ones at the distance JAX's bf16 ones are from those.
- The bf16 step computes in bf16 (hooks see bf16 conv and BatchNorm
  outputs) while parameters, gradients and optimizer state stay float32; a
  weight used at every depth step gets the float32 sum of its per-step
  gradients; checkpoints cross dtypes; the K3 packing cache repacks after an
  update of float32 parameters; ``train`` and ``test --compute_dtype bf16``
  run on a tiny tree.
"""

import contextlib
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.models import losses as jlosses
from adamvs_tpu.nn import blocks as jblocks
from adamvs_tpu.nn.costreg import AdaRedCell as JAdaRedCell
from adamvs_tpu.nn.costreg import CostRegNet2D as JCostRegNet2D
from adamvs_tpu.nn.costreg import RedCell as JRedCell
from adamvs_tpu.nn.featurenet import AdaFeatureNet as JAdaFeatureNet
from adamvs_tpu.nn.featurenet import RedFeatureNet as JRedFeatureNet
from adamvs_tpu_torch.cli import main
from adamvs_tpu_torch.config import ModelConfig
from adamvs_tpu_torch.data.synthetic import make_scene, write_whu_omvs_tree
from adamvs_tpu_torch.io.pfm import read_pfm
from adamvs_tpu_torch.models import build_model, model_loss
from adamvs_tpu_torch.nn import blocks, costreg, featurenet
from adamvs_tpu_torch.nn.blocks import init_parameters
from adamvs_tpu_torch.ops import red_scan as tred
from adamvs_tpu_torch.train import checkpoint as tckpt
from adamvs_tpu_torch.train import jax_import
from adamvs_tpu_torch.train.loop import make_eval_step, make_train_step, to_device
from adamvs_tpu_torch.train.state import create_train_state, make_optimizer
from tests.test_torch_port_msrednet import _port_state, _randomize_norms
from tests.test_torch_port_train import (
    CFG,
    DLOSSW,
    DMAX,
    DMIN,
    FAMILIES,
    _scene,
    _to_jax_variables,
    randomize_norms,
)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The module's tests on 2 CPU threads, the old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


BF16 = jnp.bfloat16
BLOCK_TOL = 2e-2
JITTER = 2.0 ** -22  # about 4 float32 steps
DRAWS = 3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- blocks and cells ------------------------------------------------------------------

def _gru_plan(gn: bool):
    if not gn:
        return [("conv_gates.0", "FastConv_0", "conv"), ("convc.0", "FastConv_1", "conv")]
    return [("gate_conv", "FastConv_0", "conv"), ("reset_gate_norm", "GroupNorm_0", "gn"),
            ("update_gate_norm", "GroupNorm_1", "gn"), ("output_conv", "FastConv_1", "conv"),
            ("output_norm", "GroupNorm_2", "gn")]


def _strip(plan):
    return [(t, f.removeprefix("cell/"), k) for t, f, k in plan]


# name: (flax module, port module, plan, input shapes NHWC, flax takes ``train``)
BLOCKS = {
    "ConvBlock": (lambda: jblocks.ConvBlock(16, 3, 2, dtype=BF16),
                  lambda: blocks.ConvBlock(8, 16, 3, 2),
                  [("conv", "FastConv_0", "conv"), ("bn", "BatchNorm_0", "bn")],
                  [(2, 16, 20, 8)], True),
    "ConvBlock_5x5": (lambda: jblocks.ConvBlock(8, 5, 2, dtype=BF16),
                      lambda: blocks.ConvBlock(3, 8, 5, 2),
                      [("conv", "FastConv_0", "conv"), ("bn", "BatchNorm_0", "bn")],
                      [(2, 16, 20, 3)], True),
    "DeconvBlock": (lambda: jblocks.DeconvBlock(8, dtype=BF16), lambda: blocks.DeconvBlock(16, 8),
                    [("conv", "FastConvTranspose_0", "convt"), ("bn", "BatchNorm_0", "bn")],
                    [(2, 8, 10, 16)], True),
    "ConvReLU": (lambda: jblocks.ConvReLU(16, 3, 2, dtype=BF16),
                 lambda: blocks.ConvReLU(8, 16, stride=2),
                 [("conv", "FastConv_0", "conv")], [(2, 16, 20, 8)], False),
    "ConvTransReLU": (lambda: jblocks.ConvTransReLU(8, dtype=BF16),
                      lambda: blocks.ConvTransReLU(16, 8),
                      [("conv", "FastConvTranspose_0", "convt")], [(2, 8, 10, 16)], False),
    "ConvGRUCell": (lambda: jblocks.ConvGRUCell(8, dtype=BF16), lambda: blocks.ConvGRUCell(8, 8),
                    _gru_plan(False), [(2, 12, 16, 8), (2, 12, 16, 8)], False),
    "GNConvGRUCell": (lambda: jblocks.GNConvGRUCell(16, dtype=BF16),
                      lambda: blocks.GNConvGRUCell(8, 16), _gru_plan(True),
                      [(2, 12, 16, 16), (2, 12, 16, 8)], False),
    "DeConvFuse": (lambda: jblocks.DeConvFuse(8, dtype=BF16), lambda: blocks.DeConvFuse(16, 8),
                   [("deconv.conv", "DeconvBlock_0/FastConvTranspose_0", "convt"),
                    ("deconv.bn", "DeconvBlock_0/BatchNorm_0", "bn"),
                    ("conv.conv", "ConvBlock_0/FastConv_0", "conv"),
                    ("conv.bn", "ConvBlock_0/BatchNorm_0", "bn")],
                   [(2, 16, 20, 8), (2, 8, 10, 16)], True),
    "CostRegNet2D": (lambda: JCostRegNet2D(8, dtype=BF16), lambda: costreg.CostRegNet2D(8),
                     jax_import._reg2d_plan(), [(2, 16, 24, 8)], True),
    "AdaRedCell_up": (lambda: JAdaRedCell(4, True, dtype=BF16),
                      lambda: costreg.AdaRedCell(8, 4, True), _strip(jax_import._reg_fuse_plan(True)),
                      [(1, 16, 20, 4), (1, 8, 10, 8), (1, 16, 20, 8)], False),
    "AdaRedCell": (lambda: JAdaRedCell(4, False, dtype=BF16),
                   lambda: costreg.AdaRedCell(16, 4, False),
                   _strip(jax_import._reg_fuse_plan(False)),
                   [(1, 16, 20, 4), (1, 8, 10, 8), (1, 16, 20, 16)], False),
    "RedCell": (lambda: JRedCell(4, dtype=BF16), lambda: costreg.RedCell(8, 4),
                _strip(jax_import._red_reg_plan()),
                [(1, 16, 24, 4), (1, 8, 12, 8), (1, 4, 6, 16), (1, 2, 3, 32), (1, 16, 24, 8)],
                False),
    "AdaFeatureNet": (lambda: JAdaFeatureNet(4, dtype=BF16), lambda: featurenet.AdaFeatureNet(4),
                      jax_import._feature_plan(), [(2, 32, 48, 3)], True),
    "RedFeatureNet": (lambda: JRedFeatureNet(4, dtype=BF16), lambda: featurenet.RedFeatureNet(4),
                      jax_import._red_feature_plan(), [(2, 32, 48, 3)], True),
    "RedFeatureNet_fpn": (lambda: JRedFeatureNet(4, arch_mode="fpn", dtype=BF16),
                          lambda: featurenet.RedFeatureNet(4, arch_mode="fpn"),
                          jax_import._red_feature_plan("fpn"), [(2, 32, 48, 3)], True),
}


def _jax_args(name, xs):
    """The flax call's positional inputs from the flat list ``xs``: the
    cells take their carry as one tuple."""
    if name.startswith("AdaRedCell"):
        return [(xs[0], xs[1]), xs[2]]
    if name == "RedCell":
        return [tuple(xs[:4]), xs[4]]
    return list(xs)


def _port_args(name, xs):
    if name.startswith("AdaRedCell"):
        return [(xs[0], xs[1]), xs[2]]
    if name == "RedCell":
        return [tuple(xs[:4]), xs[4]]
    return list(xs)


def _port_leaves(out) -> list:
    """The outputs in ``jax.tree_util.tree_leaves`` order (dicts by sorted
    key), NCHW -> NHWC."""
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _port_leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _port_leaves(o)]
    return [out.permute(0, 2, 3, 1)]


def _flax_block(name, xs32):
    """The flax block ``name`` on the inputs ``xs32`` (float32,
    bf16-rounded), computing in bf16 and in float32 from one set of
    weights: (variables, {dtype name: (forward leaves, gradient of the probe
    loss wrt (params, *inputs))}), the inputs given in the compute dtype."""
    jfn, _, _, _, takes_train = BLOCKS[name]
    extra = [True] if takes_train else []
    jmod32 = jfn().clone(dtype=None)
    init = jax.jit(lambda k, *a: jmod32.init(k, *_jax_args(name, a), *extra))(
        jax.random.PRNGKey(3), *[jnp.asarray(x) for x in xs32])
    variables = _randomize_norms(init, 5)
    stats = variables.get("batch_stats", {})
    rng = np.random.RandomState(len(name) + 1)
    probes = None
    out = {}
    for tn, dtype in (("bf16", BF16), ("f32", None)):
        jmod = jfn().clone(dtype=dtype)
        xs = [jnp.asarray(x, dtype or jnp.float32) for x in xs32]

        def forward(params, *inp, jmod=jmod):
            o = jmod.apply({"params": params, **({"batch_stats": stats} if stats else {})},
                           *_jax_args(name, inp), *extra,
                           mutable=["batch_stats"] if stats else False)
            o = o[0] if stats else o
            return jax.tree_util.tree_leaves(o[0] if name.endswith("GRUCell") else o)  # (h, h)

        if probes is None:
            probes = [rng.randn(*leaf.shape).astype(np.float32)
                      for leaf in jax.eval_shape(forward, variables["params"], *xs)]

        def loss(params, *inp, forward=forward):
            return sum(jnp.sum(o.astype(jnp.float32) * p)
                       for o, p in zip(forward(params, *inp), probes))

        out[tn] = jax.jit(lambda p, *inp, forward=forward, loss=loss: (
            forward(p, *inp), jax.grad(loss, argnums=tuple(range(1 + len(xs))))(p, *inp)))(
            variables["params"], *xs)
    return variables, probes, out


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_in_bf16_matches_flax(name):
    """Forward, input gradients and weight gradients of the block in bf16
    with float32 weights (BatchNorm in train mode) within 2e-2 relative L2 of
    the flax module with ``dtype=bf16``; the parameters and their gradients
    stay float32. Where JAX's own bf16 result lies farther than 1e-2 from its
    float32 one (the feature nets' gradients through BatchNorm statistics of
    a few pixels, AdaRedCell's through its 1-channel head), two bf16
    implementations differ by about as much, so the port's bf16 result is
    held to JAX's float32 one instead, at 1.5x JAX's bf16 distance from it."""
    _, pfn, plan, shapes, takes_train = BLOCKS[name]
    rng = np.random.RandomState(len(name))
    xs32 = [np.asarray(jnp.asarray(rng.randn(*s), BF16).astype(jnp.float32)) for s in shapes]
    variables, probes, runs = _flax_block(name, xs32)
    (leaves, grads), (leaves32, grads32) = runs["bf16"], runs["f32"]
    stats = variables.get("batch_stats", {})

    port = pfn().train(takes_train)
    port.load_state_dict(_port_state(variables["params"], stats, plan))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    txs = [torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16).requires_grad_()
           for x in xs32]
    tout = _port_leaves(port(*_port_args(name, txs)))
    assert all(t.dtype == torch.bfloat16 for t in tout)
    sum((t.float() * torch.from_numpy(p)).sum() for t, p in zip(tout, probes)).backward()
    params = dict(port.named_parameters())
    assert all(p.grad.dtype == torch.float32 for p in params.values())
    keys = sorted(params)

    def flat(ts):
        return np.concatenate([np.asarray(t, np.float64).ravel() for t in ts])

    def weights(g):
        sd = _port_state(g, stats, plan)
        return flat(sd[k].numpy() for k in keys)

    rows = {
        "forward": (flat(t.detach().float().numpy() for t in tout),
                    flat(leaf.astype(jnp.float32) for leaf in leaves), flat(leaves32)),
        "input gradient": (flat(t.grad.float().permute(0, 2, 3, 1).numpy() for t in txs),
                           flat(g.astype(jnp.float32) for g in grads[1:]), flat(grads32[1:])),
        "weight gradient": (flat(params[k].grad.numpy() for k in keys), weights(grads[0]),
                            weights(grads32[0])),
    }
    ok, lines = True, []
    for row, (got, j16, j32) in rows.items():
        err, jerr = _rel(got, j16), _rel(j16, j32)
        if jerr <= 1e-2:
            passed = err <= BLOCK_TOL
            lines.append(f"{name} {row}: {err:.2e} relative L2 to JAX bf16 (limit {BLOCK_TOL})")
        else:
            err32 = _rel(got, j32)
            passed = err32 <= 1.5 * jerr
            lines.append(f"{name} {row}: {err:.2e} relative L2 to JAX bf16; JAX bf16 is {jerr:.2e} "
                         f"from JAX f32, the port {err32:.2e} (limit {1.5 * jerr:.2e})")
        ok = ok and passed
    print("\n".join(lines))
    assert ok, "\n".join(lines)


# --- one bf16 train step against JAX ------------------------------------------------------

def _is_conv_bias(path: str) -> bool:
    return "FastConv" in path and path.endswith("bias")


def _leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _group(tree, sel) -> np.ndarray:
    leaves = _leaves(tree)
    return np.concatenate([leaves[k].ravel() for k in sorted(leaves) if sel(k)])


def _port_grads(port, tb, name, importer, variables):
    """One bf16 train step of a copy of ``port``: (loss, outputs, gradient as
    a JAX tree, BatchNorm statistics as a JAX tree, the copy)."""
    m = copy.deepcopy(port).train()
    out = m(tb["imgs"], tb["proj_matrices"], tb["depth_values"], train=True)
    loss, _ = model_loss(name)(out, tb["depth"], tb["mask"], DLOSSW)
    loss.backward()
    sd = m.state_dict()
    grads = importer({**sd, **{k: p.grad for k, p in m.named_parameters()}}, variables)[0]
    return float(loss.detach()), out, grads["params"], importer(sd, variables)[0]["batch_stats"], m


def bf16_step_case(name: str, opts: dict, fused: bool) -> dict:
    """One train step of family ``name`` in JAX at float32 and at bf16 and in
    the port at bf16 with float32 parameters (its form ``opts``), from the
    same weights and batch, and 3 more of JAX's bf16 step, and of the port's
    bf16 forward, with the weights jittered by 1 + 2^-22 n. JAX compiles
    each step once; the fused forms run its Pallas kernels in interpret
    mode."""
    from jax.experimental.pallas import tpu as pltpu

    port_cls, jcls, importer, _ = FAMILIES[name]
    batch = _scene()
    port = port_cls(**CFG, **opts, compute_dtype=torch.bfloat16)
    init_parameters(port, torch.Generator().manual_seed(1))
    randomize_norms(port, 4)
    jloss_fn = jlosses.cas_mvs_vis_loss if name == "adamvs" else jlosses.cas_rednet_loss
    jopts = {"sweep_impl": "fused" if fused else "scan"}

    def make(dtype):
        jmodel = jcls(**CFG, **jopts, dtype=dtype)

        def jstep(params, stats):
            out, mutated = jmodel.apply(
                {"params": params, "batch_stats": stats}, batch["imgs"], batch["proj_matrices"],
                batch["depth_values"], train=True, mutable=["batch_stats"])
            loss, _ = jloss_fn(out, batch["depth"], batch["mask"], DLOSSW)
            return loss, ({k: out[k]["depth"] for k in ("stage1", "stage2", "stage3")},
                          mutated["batch_stats"])

        return jmodel, jax.jit(jax.value_and_grad(jstep, has_aux=True))

    jm32, step32 = make(None)
    _, step16 = make(BF16)
    variables = _to_jax_variables(port, jm32, importer, batch)
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.RandomState(7)
    jittered = [jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + JITTER * rng.randn(*np.shape(a)))).astype(np.float32),
        params) for _ in range(DRAWS)]
    with pltpu.force_tpu_interpret_mode() if fused else contextlib.nullcontext():
        (l32, (d32, s32)), g32 = step32(params, stats)
        (l16, (d16, s16)), g16 = step16(params, stats)
        draws = [step16(p, stats) for p in jittered]
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    tb = to_device(batch, torch.device("cpu"))
    loss, out, grads, pstats, stepped = _port_grads(port, tb, name, importer, variables)
    plosses = []  # the port's loss under the same kind of jitter, as information
    for draw in range(DRAWS):
        m, gen = copy.deepcopy(port).train(), torch.Generator().manual_seed(draw)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + JITTER * torch.randn(p.shape, generator=gen))
            jout = m(tb["imgs"], tb["proj_matrices"], tb["depth_values"], train=True)
            plosses.append(float(model_loss(name)(jout, tb["depth"], tb["mask"], DLOSSW)[0]))
    return dict(name=name, l32=float(l32), l16=float(l16), d32=tonp(d32), d16=tonp(d16),
                s32=tonp(s32), s16=tonp(s16), g32=tonp(g32), g16=tonp(g16),
                jdraws=tonp([g for _, g in draws]), jlosses=[float(l) for (l, _), _ in draws],
                plosses=plosses, loss=loss, out=out, grads=tonp(grads), stats=tonp(pstats),
                stepped=stepped)


def check_loss_depth_statistics(c):
    """Loss within 2e-3 relative of JAX's bf16 loss; each stage's depth within
    max(2·max|JAX bf16 - JAX f32|, 1e-3) of the depth range; BatchNorm
    statistics within max(2·max|JAX bf16 - JAX f32|, 1e-3) of JAX's bf16
    statistics."""
    assert np.isfinite(c["loss"])
    lerr = abs(c["loss"] - c["l16"]) / abs(c["l16"])
    jspread = max(abs(j - c["l16"]) for j in c["jlosses"]) / abs(c["l16"])
    pspread = max(abs(j - c["loss"]) for j in c["plosses"]) / abs(c["loss"])
    print(f"{c['name']}: loss {c['loss']:.5f}, JAX bf16 {c['l16']:.5f}, f32 {c['l32']:.5f}: "
          f"{lerr:.2e} relative (limit 2e-3); under the weight jitter JAX's bf16 loss moves "
          f"up to {jspread:.2e}, the port's {pspread:.2e}")
    assert lerr <= 2e-3
    span = DMAX - DMIN
    for key in ("stage1", "stage2", "stage3"):
        got = c["out"][key]["depth"]
        assert got.dtype == torch.float32
        err = np.abs(got.detach().numpy() - c["d16"][key]).max() / span
        limit = max(2 * np.abs(c["d16"][key] - c["d32"][key]).max() / span, 1e-3)
        print(f"  {key} depth {err:.2e} of the range (limit {limit:.2e})")
        assert err <= limit, key
    got, want, ref = (_group(t, lambda k: True) for t in (c["stats"], c["s16"], c["s32"]))
    err, limit = np.abs(got - want).max(), max(2 * np.abs(want - ref).max(), 1e-3)
    print(f"  BatchNorm statistics {err:.2e} (limit {limit:.2e})")
    assert err <= limit


def check_gradient(c):
    """The whole gradient: rel L2(port - JAX f32) <= 1.5 rel L2(JAX bf16 -
    JAX f32). Per top-level module, its leaves but the conv biases: rel
    L2(port - JAX bf16) <= 2 noise, noise the largest distance of a jittered
    draw of JAX's bf16 step from it; its conv biases: rel L2(port -
    JAX f32) <= 1.5 rel L2(JAX bf16 - JAX f32) (module docstring)."""
    whole = _rel(_group(c["grads"], lambda k: True), _group(c["g32"], lambda k: True))
    jwhole = _rel(_group(c["g16"], lambda k: True), _group(c["g32"], lambda k: True))
    lines = [f"{c['name']}: whole gradient rel L2 to JAX f32 {whole:.3f} (limit 1.5 x "
             f"{jwhole:.3f}, JAX bf16's)"]
    ok = whole <= 1.5 * jwhole
    for m in sorted(c["g16"]):
        for part, sel in (("weights", lambda k: not _is_conv_bias(k)), ("conv biases", _is_conv_bias)):
            if not any(sel(k) for k in _leaves(c["g16"][m])):
                continue
            got, j16, j32 = (_group(t[m], sel) for t in (c["grads"], c["g16"], c["g32"]))
            if part == "weights":
                noise = max(_rel(_group(d[m], sel), j16) for d in c["jdraws"])
                err, limit = _rel(got, j16), 2 * noise
                lines.append(f"  {m} {part}: port vs JAX bf16 {err:.3f}, noise {noise:.3f}, "
                             f"limit {limit:.3f}; JAX bf16 vs f32 {_rel(j16, j32):.3f}")
            else:
                err, limit = _rel(got, j32), 1.5 * _rel(j16, j32)
                lines.append(f"  {m} {part}: port vs JAX f32 {err:.3f}, limit {limit:.3f} "
                             f"(JAX bf16 vs f32 x 1.5); port vs JAX bf16 {_rel(got, j16):.3f}")
            ok = ok and err <= limit
    print("\n".join(lines))
    assert ok, "\n".join(lines)


def check_float32_master(c):
    """Parameters and gradients float32 after the bf16 step."""
    m = c["stepped"]
    assert m.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in m.parameters())


SCAN = {"adamvs": {"sweep_impl": "scan", "reg_impl": "scan"}, "msrednet": {"sweep_impl": "scan"}}


@pytest.fixture(scope="module", params=sorted(SCAN))
def scan_case(request):
    return bf16_step_case(request.param, SCAN[request.param], fused=False)


def test_bf16_scan_step_loss_depth_and_statistics_match_jax(scan_case):
    check_loss_depth_statistics(scan_case)


def test_bf16_scan_step_gradient_matches_jax(scan_case):
    check_gradient(scan_case)


def test_bf16_scan_step_keeps_float32_master_weights(scan_case):
    check_float32_master(scan_case)


# --- what the bf16 step computes in ----------------------------------------------------

@pytest.mark.parametrize("name", ["adamvs", "msrednet"])
def test_bf16_step_computes_in_bf16_with_float32_parameters(name):
    """Forward hooks see bf16 outputs of every conv and BatchNorm; the
    parameters, their gradients and RMSprop's state stay float32."""
    model = build_model(name, seed=0, device="cpu", compute_dtype=torch.bfloat16,
                        ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4))
    seen = {}

    def hook(mod, inp, out):
        seen.setdefault(type(mod).__name__, set()).add(out.dtype)

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.BatchNorm2d)):
            m.register_forward_hook(hook)
    state = create_train_state(model, make_optimizer(model.parameters()))
    batch = to_device(_scene(), torch.device("cpu"))
    batch["depth"] = {k: v for k, v in batch["depth"].items() if k != "stage3"}
    batch["mask"] = {k: v for k, v in batch["mask"].items() if k != "stage3"}
    make_train_step(model_loss(name), DLOSSW)(state, batch)
    assert seen.keys() >= {"Conv2d", "BatchNorm2d"} and "ConvTranspose2d" in seen
    assert all(d == {torch.bfloat16} for d in seen.values()), seen
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    opt_state = [t for s in state.optimizer.state.values() for t in s.values()
                 if torch.is_tensor(t) and t.is_floating_point()]
    assert opt_state and all(t.dtype == torch.float32 for t in opt_state)


def test_weight_used_at_every_step_gets_the_float32_sum_of_its_gradients():
    """A conv applied at 48 depth steps to bf16 inputs: its float32 weight
    receives the per-step bf16 weight gradients summed in float32 (within a
    float32 rounding of each addition of their float64 sum), closer to that
    float64 sum than the same gradients summed in bf16."""
    conv = blocks.Conv2d(8, 8, 3, padding=1)
    init_parameters(conv, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    D = 48
    xs = [torch.randn((1, 8, 12, 16), generator=gen).bfloat16() for _ in range(D)]
    probes = [torch.randn((1, 8, 12, 16), generator=gen).bfloat16() for _ in range(D)]
    per_step = []
    for x, p in zip(xs, probes):
        conv.zero_grad()
        (conv(x) * p).float().sum().backward()
        per_step.append(conv.weight.grad.clone())
    conv.zero_grad()
    sum((conv(x) * p).float().sum() for x, p in zip(xs, probes)).backward()
    got = conv.weight.grad
    assert got.dtype == torch.float32
    want = torch.stack([g.double() for g in per_step]).sum(dim=0)
    in_bf16 = per_step[0].bfloat16()
    for g in per_step[1:]:
        in_bf16 = in_bf16 + g.bfloat16()
    err = float((got.double() - want).norm() / want.norm())
    err_bf16 = float((in_bf16.double() - want).norm() / want.norm())
    assert err < 1e-6 < err_bf16, (err, err_bf16)


# --- checkpoints, the K3 packing cache ---------------------------------------------------

def test_checkpoints_cross_dtypes(tmp_path):
    """A bf16 run's checkpoint (float32 master weights) loads into a float32
    run and into a bf16 inference model; a float32 run's loads into a bf16
    run, optimizer state included."""
    kw = dict(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4),
              sweep_impl="fused")
    cfg = dict(model="msrednet", ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0),
               cr_base_chs=(4, 4), base_channels=4, sweep_impl="fused")
    bf = ModelConfig(dtype="bf16", **cfg).build(device="cpu", train=True)
    assert bf.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    state = create_train_state(bf, make_optimizer(bf.parameters()))
    batch = to_device(_scene(), torch.device("cpu"))
    for d in ("depth", "mask"):
        batch[d] = {k: v for k, v in batch[d].items() if k != "stage3"}
    make_train_step(model_loss("msrednet"), DLOSSW)(state, batch)
    path = tckpt.save_checkpoint(str(tmp_path), state, 0)
    f32 = build_model("msrednet", seed=5, device="cpu", **kw)
    f32_state = create_train_state(f32, make_optimizer(f32.parameters()))
    tckpt.restore_checkpoint(path, f32_state)
    for (k, a), b in zip(bf.state_dict().items(), f32.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert f32_state.step == 1
    assert all(torch.equal(a, b) for s, t in zip(state.optimizer.state.values(),
                                                  f32_state.optimizer.state.values())
               for a, b in zip(s.values(), t.values()))
    infer = ModelConfig(dtype="bf16", **cfg).build(device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in infer.parameters())
    infer.load_state_dict(torch.load(path, weights_only=True)["model"])
    assert all(torch.equal(p, q.bfloat16()) for p, q in zip(infer.parameters(), bf.parameters()))
    make_train_step(model_loss("msrednet"), DLOSSW)(f32_state, batch)
    path32 = tckpt.save_checkpoint(str(tmp_path), f32_state, 1)
    back = ModelConfig(dtype="bf16", **cfg).build(device="cpu", train=True, seed=9)
    back_state = create_train_state(back, make_optimizer(back.parameters()))
    tckpt.restore_checkpoint(path32, back_state)
    assert all(torch.equal(p, q) for p, q in zip(back.parameters(), f32.parameters()))
    assert back_state.step == 2


def test_k3_packing_repacks_after_an_update_of_float32_parameters():
    """The eval step of a bf16 AdaMVS run packs K3's bf16 weights from the
    float32 parameters; after an optimizer step the cache packs them again,
    equal to a fresh pack."""
    cell = costreg.AdaRedCell(8, 8, True)
    init_parameters(cell, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in cell.parameters())
    first = [t.clone() for t in tred._packed_weights(cell, torch.bfloat16)]
    assert tred._packed_weights(cell, torch.bfloat16)[0] is tred._PACKED[cell][1][0]  # a hit
    opt = make_optimizer(cell.parameters(), lr=1e-2)
    for p in cell.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    again = tred._packed_weights(cell, torch.bfloat16)
    fresh = tred.pack_red_fragments(cell)
    assert all(torch.equal(a, b) for a, b in zip(again, fresh))
    assert not all(torch.equal(a, b) for a, b in zip(first, again))
    # the float32 form of the eval step has its own key
    assert tred._packed_weights(cell, torch.float32)[0].dtype == torch.float32


# --- the commands --------------------------------------------------------------------------

TINY = ["--view_num", "3", "--ndepths", "8,4", "--depth_inter_r", "4,2", "--cr_base_chs", "4,4",
        "--dlossw", "0.5,1.0", "--device", "cpu"]


@pytest.mark.parametrize("model,form", [("adamvs", "scan"), ("msrednet", "fused")])
def test_train_and_test_commands_in_bf16(tmp_path, capsys, model, form):
    """``train --compute_dtype bf16`` runs an epoch with float32 parameters
    and optimizer state and writes a float32 checkpoint; ``test
    --compute_dtype bf16`` and ``test`` (float32) both load it and export
    finite PFMs; ``profile --compute_dtype bf16`` writes its trace."""
    tree = str(tmp_path / "tree")
    write_whu_omvs_tree(tree, make_scene(num_views=4, height=64, width=96, seed=0))
    logdir = str(tmp_path / "logs")
    flags = TINY + ["--model", model, "--sweep_impl", form]
    trainer = main(["train", "--trainpath", tree, "--logdir", logdir, "--epochs", "1",
                    "--summary_freq", "1", "--compute_dtype", "bf16"] + flags)
    model_ = trainer.state.model
    assert model_.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model_.parameters())
    assert all(t.dtype == torch.float32 for s in trainer.state.optimizer.state.values()
               for t in s.values() if torch.is_tensor(t) and t.is_floating_point())
    assert trainer.state.step == 4 and trainer.state.nan_steps == 0
    ckpt = tckpt.latest_checkpoint(logdir)
    assert ckpt and all(t.dtype in (torch.float32, torch.int64)
                        for t in torch.load(ckpt, weights_only=True)["model"].values())
    out = capsys.readouterr().out
    assert "Epoch 0, iter 3" in out
    finals = {}
    for dt in ("bf16", "f32"):
        finals[dt] = main(["test", "--testpath", tree, "--logdir", logdir,
                           "--compute_dtype", dt] + flags)
        root = os.path.join(tree, "depths_whu_omvs", "images")
        pfms = [os.path.join(root, f) for f in os.listdir(root) if f.endswith(".pfm")]
        assert len(pfms) == 8
        for p in pfms:
            assert np.isfinite(read_pfm(p)[0]).all(), p
    assert all(np.isfinite(v) for f in finals.values() for v in f.values())
    # the same checkpoint evaluated in bf16 and in float32
    assert abs(finals["bf16"]["abs_depth_error"] - finals["f32"]["abs_depth_error"]) < 5.0
    trace = main(["profile", "--testpath", tree, "--warmup", "1", "--iters", "1", "--trace_dir",
                  str(tmp_path / "trace"), "--compute_dtype", "bf16"] + flags)
    assert os.path.getsize(trace) > 0


def test_eval_step_of_a_bf16_run_matches_the_cast_model():
    """The Trainer's eval step on float32 master weights computing in bf16
    gives what the bf16-cast inference model gives (the same bf16 weights,
    cast at each call or once)."""
    kw = dict(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4),
              sweep_impl="fused", reg_impl="scan")
    master = build_model("adamvs", seed=2, device="cpu", compute_dtype=torch.bfloat16, **kw)
    cast = build_model("adamvs", seed=2, device="cpu", dtype=torch.bfloat16, **kw)
    batch = to_device(_scene(), torch.device("cpu"))
    for d in ("depth", "mask"):
        batch[d] = {k: v for k, v in batch[d].items() if k != "stage3"}
    estep = make_eval_step(model_loss("adamvs"), DLOSSW, 2)
    got = estep(create_train_state(master, make_optimizer(master.parameters())), batch)
    want = estep(create_train_state(cast, make_optimizer(cast.parameters())), batch)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
