"""Training with the port against the JAX package at float32 on the CPU.

- K5's plain backward (the autograd Functions ``*_sweep_volume_t`` on CPU
  tensors) against ``jax.grad`` through the exact gather forms
  ``_xla_*_volume``, for the corr, fused and var modes, at ragged shapes.
- One train step of AdaMVS and of MS-REDNet against JAX ``value_and_grad`` of
  ``model.apply(..., train=True, mutable=["batch_stats"])``: loss, per-stage
  depth, the whole gradient (mapped through the JAX package's importer) and
  the BatchNorm statistics after the step. The JAX models run
  ``sweep_impl="scan"``, the exact streaming form.
- The optimizer, the learning-rate schedule, the NaN guard, checkpoints and
  resume order, losses and metrics, the Trainer, and that training lowers
  the loss.

The weights are the port's seeded init with random BatchNorm and GroupNorm
parameters and statistics, carried to JAX by the JAX package's importer into
a variables tree shaped by ``jax.eval_shape`` (no flax init is compiled)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.config import parse_lrepochs as jparse_lrepochs
from adamvs_tpu.models import AdaMVS as JAdaMVS
from adamvs_tpu.models import MSREDNet as JMSREDNet
from adamvs_tpu.models import losses as jlosses
from adamvs_tpu.ops.sweep_fuse import _xla_corr_volume, _xla_fused_volume, _xla_var_volume
from adamvs_tpu.train import metrics as jmetrics
from adamvs_tpu.train.state import make_lr_schedule as jmake_lr_schedule
from adamvs_tpu.train.state import make_optimizer as jmake_optimizer
from adamvs_tpu.train.torch_import import import_adamvs_state_dict, import_msrednet_state_dict
from adamvs_tpu_torch.models import AdaMVS, MSREDNet, model_loss
from adamvs_tpu_torch.models import losses as tlosses
from adamvs_tpu_torch.nn.blocks import BatchNorm2d, init_parameters
from adamvs_tpu_torch.ops import sweep_fuse as tsweep
from adamvs_tpu_torch.train import checkpoint as tckpt
from adamvs_tpu_torch.train import metrics as tmetrics
from adamvs_tpu_torch.train.loop import Trainer, make_train_step, to_device
from adamvs_tpu_torch.train.state import (
    apply_updates_if_finite,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    parse_lrepochs,
)
from tests.test_torch_import_msrednet import _real_cameras
from tests.test_torch_port_model import _flatten, _projs

torch.set_num_threads(2)

CFG = dict(ndepths=(8, 4, 4), depth_intervals_ratio=(4.0, 2.0, 1.0), base=8, cr_base=(8, 8, 8))
TINY = dict(ndepths=(8, 4), depth_intervals_ratio=(4.0, 2.0), base=4, cr_base=(4, 4))
DLOSSW = (0.5, 1.0, 2.0)
DMIN, DMAX = 300.0, 500.0


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- K5: the plain backward against jax.grad of the exact forms ------------------------

def _k5_case(seed, B, Vs, h, w, C):
    """Random features and weights, x-baselines with one rotated view, and
    per-pixel windows of which a third start behind the camera; near depths
    send taps out of the image."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    srcs = rng.randn(Vs, B, h, w, C).astype(np.float32)
    proj = _real_cameras(B, Vs + 1, h, w, f=40.0, baseline=0.6)
    proj[:, 2, :3, :3] += (0.03 * rng.randn(B, 3, 3)).astype(np.float32)
    ref_proj = proj[:, 0]
    src_projs = np.ascontiguousarray(proj[:, 1:].transpose(1, 0, 2, 3))
    weights = rng.rand(B, h, w, Vs).astype(np.float32)
    lo = (20.0 + 3.0 * rng.randn(B, h, w)).astype(np.float32)
    lo[:, :, : w // 3] -= 24.0
    step = (0.9 + 0.1 * rng.rand(B, h, w)).astype(np.float32)
    return ref, srcs, weights, src_projs, ref_proj, lo, step


@pytest.mark.parametrize("mode,B,Vs,h,w,C,D", [
    ("corr", 2, 3, 9, 13, 8, 11), ("corr", 1, 2, 8, 10, 32, 6),
    ("fused", 2, 3, 9, 13, 16, 5), ("fused", 1, 4, 8, 10, 32, 9),
    ("var", 2, 3, 9, 13, 32, 5), ("var", 1, 2, 10, 8, 8, 11),
])
def test_k5_plain_backward_matches_jax(mode, B, Vs, h, w, C, D):
    """d ref, d srcs and d weights of sum(vol * probe) within 1e-5 of
    max|JAX| in float32; the projections, lo and step get no gradient."""
    ref, srcs, weights, src_projs, ref_proj, lo, step = _k5_case(
        C + D + B, B, Vs, h, w, C)
    rng = np.random.RandomState(D)
    geo = [jnp.asarray(a) for a in (src_projs, ref_proj, lo, step)]
    if mode == "corr":
        probe = rng.randn(Vs, B, h, w, D).astype(np.float32)  # JAX layout [Vs,B,h,w,D]

        def jloss(r, s):
            return jnp.sum(_xla_corr_volume(r, s, *geo, D) * probe)

        want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ref), jnp.asarray(srcs))
        tprobe = _t(probe).permute(0, 1, 4, 2, 3)
    else:
        probe = rng.randn(D, B, h, w, C).astype(np.float32)  # JAX layout [D,B,h,w,C]
        tprobe = _t(probe).permute(0, 1, 4, 2, 3)
        if mode == "fused":
            def jloss(r, s, wt):
                return jnp.sum(_xla_fused_volume(r, s, wt, *geo, D) * probe)

            want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(ref), jnp.asarray(srcs),
                                                      jnp.asarray(weights))
            want = (*want[:2], np.asarray(want[2]).transpose(0, 3, 1, 2))
        else:
            def jloss(r, s):
                return jnp.sum(_xla_var_volume(r, s, *geo, D) * probe)

            want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ref), jnp.asarray(srcs))

    tref, tsrcs = _t(ref).requires_grad_(), _t(srcs).requires_grad_()
    tw = _t(weights).permute(0, 3, 1, 2).contiguous().requires_grad_()
    nograd = [_t(a).requires_grad_() for a in (src_projs, ref_proj, lo, step)]
    if mode == "corr":
        vol, inputs = tsweep.corr_sweep_volume_t(tref, tsrcs, *nograd, D), [tref, tsrcs]
    elif mode == "fused":
        vol, inputs = tsweep.fused_sweep_volume_t(tref, tsrcs, tw, *nograd, D), [tref, tsrcs, tw]
    else:
        vol, inputs = tsweep.var_sweep_volume_t(tref, tsrcs, *nograd, D), [tref, tsrcs]
    got = torch.autograd.grad((vol * tprobe).sum(), inputs + nograd, allow_unused=True)
    assert all(g is None for g in got[len(inputs):])
    for g, wnt, name in zip(got, want, ("ref", "srcs", "weights")):
        wnt = np.asarray(wnt)
        assert g.dtype == torch.float32 and g.shape == wnt.shape, name
        assert np.abs(wnt).max() > 0, name
        err = np.abs(g.numpy() - wnt).max() / np.abs(wnt).max()
        assert err <= 1e-5, f"{mode} d{name}: {err:.2e} of max|JAX|"
    assert (np.abs(np.asarray(want[1])).reshape(Vs, -1).max(axis=1) > 0).all()


def test_k5_backward_wrappers_keep_the_primal_dtypes():
    """The CPU wrappers of K5 give bf16 gradients for bf16 features and a
    float32 weight gradient, and count no launch."""
    ref, srcs, weights, src_projs, ref_proj, lo, step = _k5_case(4, 1, 2, 6, 8, 8)
    bref, bsrcs = _t(ref).bfloat16(), _t(srcs).bfloat16()
    geo = [_t(a) for a in (src_projs, ref_proj, lo, step)]
    wn = tsweep.normalize_weights(_t(weights).permute(0, 3, 1, 2))
    g = torch.randn((3, 1, 8, 6, 8)).bfloat16()
    wrappers = (tsweep.corr_sweep_volume_bwd, tsweep.fused_sweep_volume_bwd,
                tsweep.var_sweep_volume_bwd)
    before = [fn.launches for fn in wrappers]
    dref, dsrcs = tsweep.corr_sweep_volume_bwd(torch.randn((2, 1, 3, 6, 8)), bref, bsrcs, *geo)
    assert dref.dtype == dsrcs.dtype == torch.bfloat16
    dref, dsrcs, dwn = tsweep.fused_sweep_volume_bwd(g, bref, bsrcs, wn, *geo)
    assert dref.dtype == dsrcs.dtype == torch.bfloat16 and dwn.dtype == torch.float32
    dref, dsrcs = tsweep.var_sweep_volume_bwd(g, bref, bsrcs, *geo)
    assert dref.dtype == dsrcs.dtype == torch.bfloat16 and dsrcs.shape == bsrcs.shape
    assert [fn.launches for fn in wrappers] == before


# --- one train step against JAX ---------------------------------------------------------

def randomize_norms(model: torch.nn.Module, seed: int) -> None:
    """Random BatchNorm weight/bias/statistics and GroupNorm weight/bias, so
    a swapped mapping or a wrong statistics update cannot cancel out."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                n = m.weight.shape[0]
                m.weight.copy_(_t(1 + 0.3 * rng.randn(n).astype(np.float32)))
                m.bias.copy_(_t(0.3 * rng.randn(n).astype(np.float32)))
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(_t(0.3 * rng.randn(n).astype(np.float32)))
                m.running_var.copy_(_t(0.5 + rng.rand(n).astype(np.float32)))


def _scene(B=1, V=3, H=64, W=64, seed=11):
    """Images, cameras, [B,3] depth values, and a smooth GT pyramid with
    all-ones masks."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(B, V, H, W, 3).astype(np.float32)
    coarse = rng.uniform(340, 460, (B, 1, 4, 4)).astype(np.float32)
    gt = torch.nn.functional.interpolate(_t(coarse), size=(H, W), mode="bilinear",
                                         align_corners=False)[:, 0].numpy()
    depth = {"stage1": gt[:, ::4, ::4], "stage2": gt[:, ::2, ::2], "stage3": gt}
    return {
        "imgs": imgs, "proj_matrices": _projs(B, V, H, W),
        "depth_values": np.array([[DMIN, DMAX, (DMAX - DMIN) / 32]] * B, np.float32),
        "depth": {k: np.ascontiguousarray(v) for k, v in depth.items()},
        "mask": {k: np.ones_like(v) for k, v in depth.items()},
        "depth_interval": np.full((B,), (DMAX - DMIN) / 32, np.float32),
    }


FAMILIES = {
    "adamvs": (AdaMVS, JAdaMVS, import_adamvs_state_dict, {}),
    "msrednet": (MSREDNet, JMSREDNet, import_msrednet_state_dict, {"sweep_impl": "fused"}),
}


class _Relu(torch.overrides.TorchFunctionMode):
    """While active, keeps the input of every ``F.relu`` call or, given
    masks in call order (``flip``), computes each call with the decisions
    under its mask inverted."""

    def __init__(self, flip=None):
        super().__init__()
        self.inputs, self.flip, self.calls = [], flip, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is not torch.nn.functional.relu:
            return func(*args, **(kwargs or {}))
        x = args[0]
        self.calls += 1
        if self.flip is None:
            self.inputs.append(x.detach().clone())
            return func(*args, **(kwargs or {}))
        keep = (x > 0) ^ self.flip[self.calls - 1]
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype))


def relu_margin(model, batch, name, k=4.0, draws=2):
    """How close the model's ReLU decisions lie to float32 rounding, in one
    train step on ``batch``: (the number of ReLU inputs within ``k`` times
    their rounding sensitivity of 0, the relative L2 change of the gradient
    when all of those decisions are flipped). The sensitivity of an input is
    how far it moves when every weight is multiplied by 1 + 2^-24 n (n
    standard normal, which moves about half the weights by one float32
    step), the most over ``draws`` draws. A second framework's rounding can
    flip only such decisions, so a small change means its gradient can
    differ from this one by rounding alone."""
    def run(m, mode, backward):
        m = copy.deepcopy(m).train()
        with mode, torch.set_grad_enabled(backward):
            out = m(batch["imgs"], batch["proj_matrices"], batch["depth_values"], train=True)
            loss, _ = model_loss(name)(out, batch["depth"], batch["mask"], DLOSSW)
        if backward:
            loss.backward()
            return torch.cat([p.grad.flatten() for p in m.parameters()])
        return mode.inputs

    xs = run(model, _Relu(), False)
    moved = [torch.zeros_like(x) for x in xs]
    for seed in range(draws):
        jittered = copy.deepcopy(model)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in jittered.parameters():
                p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=gen))
        moved = [torch.maximum(d, (a - b).abs())
                 for d, a, b in zip(moved, xs, run(jittered, _Relu(), False))]
    near = [x.abs() < k * d for x, d in zip(xs, moved)]
    g0, g1 = run(model, _Relu(), True), run(model, _Relu(flip=near), True)
    return sum(int(n.sum()) for n in near), float((g1 - g0).norm() / g0.norm())


def _to_jax_variables(port, jmodel, importer, batch):
    """The port's weights as a JAX variables tree: zeros shaped by
    ``jax.eval_shape`` of the flax init, filled by the JAX importer."""
    abstract = jax.eval_shape(lambda k: jmodel.init(
        k, batch["imgs"], batch["proj_matrices"], batch["depth_values"]), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    variables, _ = importer(port.state_dict(), zeros)
    return variables


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def train_step_case(request):
    return _train_step_case(request.param)


def _train_step_case(name, opts=None):
    """One train step of family ``name`` in JAX and in the port, from the
    same weights and batch; the port's model takes ``opts`` (its form) in
    place of the family's."""
    port_cls, jcls, importer, family_opts = FAMILIES[name]
    opts = family_opts if opts is None else opts
    batch = _scene()
    port = port_cls(**CFG, **opts)
    # A ReLU input within float32 rounding of 0 takes opposite sides in the
    # two frameworks about once in a million activations, and one such flip
    # moves the gradient by up to ~1e-2 here (float64 agrees to 5e-7). These
    # weights keep the decisions near 0 harmless, as ``relu_margin`` checks
    # (flipping them all moves the gradient by 8e-6 / 1e-5; the gradients
    # agree with JAX to 3.0e-5 / 2.9e-5, AdaMVS / MS-REDNet).
    init_parameters(port, torch.Generator().manual_seed(1))
    randomize_norms(port, 4)
    tb = to_device(batch, torch.device("cpu"))
    margin = relu_margin(port, tb, name)
    jmodel = jcls(**CFG)
    variables = _to_jax_variables(port, jmodel, importer, batch)
    jloss_fn = jlosses.cas_mvs_vis_loss if name == "adamvs" else jlosses.cas_rednet_loss

    def jstep(params, stats):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": stats}, batch["imgs"], batch["proj_matrices"],
            batch["depth_values"], train=True, mutable=["batch_stats"])
        loss, _ = jloss_fn(out, batch["depth"], batch["mask"], DLOSSW)
        return loss, ({k: out[k]["depth"] for k in ("stage1", "stage2", "stage3")}, mutated)

    (jloss, (jdepth, mutated)), jgrads = jax.jit(jax.value_and_grad(jstep, has_aux=True))(
        variables["params"], variables["batch_stats"])

    port.train()
    out = port(tb["imgs"], tb["proj_matrices"], tb["depth_values"], train=True)
    loss, _ = model_loss(name)(out, tb["depth"], tb["mask"], DLOSSW)
    loss.backward()
    # the port's gradients and statistics, as JAX trees through the importer
    sd = port.state_dict()
    grad_sd = {**sd, **{k: p.grad for k, p in port.named_parameters()}}
    got_grads, _ = importer(grad_sd, variables)
    return dict(name=name, jloss=float(jloss), jdepth=jdepth, jgrads=jgrads,
                jstats=mutated["batch_stats"], loss=float(loss.detach()), out=out,
                grads=got_grads["params"], stats=importer(sd, variables)[0]["batch_stats"],
                margin=margin)


def test_train_step_loss_and_depth_match_jax(train_step_case):
    c = train_step_case
    assert np.isfinite(c["loss"]) and c["loss"] > 0
    assert abs(c["loss"] - c["jloss"]) <= 1e-5 * abs(c["jloss"]), (c["loss"], c["jloss"])
    for key in ("stage1", "stage2", "stage3"):
        got = c["out"][key]["depth"].detach().numpy()
        want = np.asarray(c["jdepth"][key])
        assert got.shape == want.shape
        assert np.abs(got - want).max() / (DMAX - DMIN) < 1e-4, key


def test_train_step_gradient_matches_jax(train_step_case):
    """The whole flattened gradient within 1e-4 relative L2, from weights
    whose ReLU decisions near float32 rounding move the gradient by at most
    half of that."""
    c = train_step_case
    near, change = c["margin"]
    assert change < 5e-5, (
        f"{c['name']}: flipping the {near} ReLU decisions that lie within float32 rounding of "
        f"0 moves the gradient by {change:.1e}. The test weights lost their margin: the two "
        "frameworks' rounding may take different ReLU branches, so the gradients need not "
        "agree. Choose weights whose relu_margin change stays below 5e-5.")
    want, got = _flatten(c["jgrads"]), _flatten(c["grads"])
    assert want.keys() == got.keys() and len(want) > 50
    w = np.concatenate([want[k].ravel() for k in sorted(want)])
    g = np.concatenate([got[k].ravel() for k in sorted(want)])
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel < 1e-4, f"{c['name']} gradient rel L2 {rel:.2e}"


def test_train_step_batchnorm_statistics_match_jax(train_step_case):
    """Running mean and variance after one train step within 1e-5: flax
    moves the running variance toward the biased batch variance."""
    c = train_step_case
    want, got = _flatten(c["jstats"]), _flatten(c["stats"])
    assert want.keys() == got.keys() and len(want) > 20
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_batchnorm_keeps_flax_statistics():
    """The port's BatchNorm2d: biased variance into the running variance in
    train mode, nn.BatchNorm2d in eval mode."""
    x = torch.randn(2, 3, 2, 2) * 3 + 1
    bn = BatchNorm2d(3).train()
    y = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(y, torch.nn.functional.batch_norm(x, None, None, training=True))
    assert int(bn.num_batches_tracked) == 1
    ref = torch.nn.BatchNorm2d(3)
    ref.load_state_dict(bn.state_dict())
    bn.eval(), ref.eval()
    torch.testing.assert_close(bn(x), ref(x))


# --- optimizer, schedule, NaN guard -----------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_rmsprop_matches_jax_optimizer(weight_decay):
    w0 = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    grads = [np.array(g, np.float32) for g in (
        [0.1, -0.2, 0.3, 0.0], [0.5, 0.5, -0.5, 1e-3], [-1.0, 0.2, 0.0, 2.0])]
    tw = torch.nn.Parameter(_t(w0.copy()))
    opt = make_optimizer([tw], lr=0.01, weight_decay=weight_decay)
    tx = jmake_optimizer(lr=0.01, weight_decay=weight_decay)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    for g in grads:
        tw.grad = _t(g.copy())
        opt.step()
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = params + updates
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-6)


def test_lr_schedule_matches_jax():
    milestones, gamma = parse_lrepochs("10,12,14:2")
    assert (milestones, gamma) == jparse_lrepochs("10,12,14:2")
    ours = make_lr_schedule(1e-3, milestones, gamma, steps_per_epoch=100)
    theirs = jmake_lr_schedule(1e-3, list(milestones), gamma, steps_per_epoch=100)
    for n in (0, 999, 1000, 1001, 1199, 1200, 1399, 1400, 5000):
        assert ours(n) == pytest.approx(float(theirs(n)), rel=1e-6), n


def test_scheduled_updates_match_the_jax_chain():
    """RMSprop under the schedule across a milestone, one update per step,
    against the optax chain the JAX package builds from the same schedule."""
    w0 = np.array([1.0, -2.0], np.float32)
    sched = make_lr_schedule(0.1, [2], 0.5, steps_per_epoch=1)
    tw = torch.nn.Parameter(_t(w0.copy()))
    state = create_train_state(torch.nn.Linear(1, 1), make_optimizer([tw], lr=0.1), sched)
    tx = jmake_optimizer(lr=jmake_lr_schedule(0.1, [2], 0.5, steps_per_epoch=1))
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    for i in range(4):
        g = np.array([0.3 * (i + 1), -0.1], np.float32)
        tw.grad = _t(g)
        assert apply_updates_if_finite(state, torch.tensor(1.0))
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = params + updates
    assert state.step == 4 and state.optimizer.param_groups[0]["lr"] == pytest.approx(0.05)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params), rtol=1e-6)


@pytest.fixture()
def tiny(synthetic_scene):
    """A 2-stage AdaMVS (base 4) on the synthetic scene, float32 on the CPU."""
    from tests.test_models import scene_batch

    imgs, projs, dv = scene_batch(synthetic_scene)
    gt = synthetic_scene.views[0].depth[None].astype(np.float32)
    batch = {
        "imgs": np.asarray(imgs), "proj_matrices": {k: np.asarray(v) for k, v in projs.items()},
        "depth_values": np.asarray(dv),
        "depth": {"stage1": gt[:, ::4, ::4].copy(), "stage2": gt},
        "mask": {"stage1": np.ones_like(gt[:, ::4, ::4]), "stage2": np.ones_like(gt)},
        "depth_interval": np.array([synthetic_scene.depth_interval], np.float32),
    }
    model = AdaMVS(**TINY)
    init_parameters(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(model.parameters(), lr=1e-3))
    return state, batch


def test_train_step_reduces_loss(tiny):
    state, batch = tiny
    step = make_train_step(model_loss("adamvs"), (0.5, 1.0))
    tb = to_device(batch, torch.device("cpu"))
    losses = [float(step(state, tb)[1]["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses))
    assert state.step == 6 and state.nan_steps == 0
    assert losses[-1] < losses[0], losses


def test_nan_guard_skips_update(tiny):
    """A NaN GT: the step is counted in nan_steps, parameters and optimizer
    state stay as they were, the step counter advances."""
    state, batch = tiny
    step = make_train_step(model_loss("adamvs"), (0.5, 1.0))
    tb = to_device(batch, torch.device("cpu"))
    step(state, tb)  # one finite update, so the optimizer has state to keep
    params = {k: v.clone() for k, v in state.model.named_parameters()}
    opt = {k: v.clone() for k, v in state.optimizer.state[next(state.model.parameters())].items()}
    bad = dict(tb, depth={k: v * float("nan") for k, v in tb["depth"].items()})
    _, metrics, _ = step(state, bad)
    assert not np.isfinite(float(metrics["loss"]))
    assert state.nan_steps == 1 and state.step == 2
    for k, v in state.model.named_parameters():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0, msg=k)
    for k, v in state.optimizer.state[next(state.model.parameters())].items():
        torch.testing.assert_close(v, opt[k], rtol=0, atol=0, msg=k)


# --- checkpoints, resume and the Trainer -------------------------------------------------

def test_checkpoint_round_trip(tmp_path, tiny):
    state, _ = tiny
    state.step, state.nan_steps = 7, 2
    save_checkpoint = tckpt.save_checkpoint
    save_checkpoint(str(tmp_path), state, epoch=0, metric=0.1234)
    save_checkpoint(str(tmp_path), state, epoch=1, metric=0.0999)
    path = tckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("model_000001_0.0999.ckpt")
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"epoch", "model", "optimizer", "step", "nan_steps"}
    assert "DepthNet.0.reg.conv0.bn.running_var" in ckpt["model"]
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    with torch.no_grad():
        for p in state.model.parameters():
            p.zero_()
    state.step = state.nan_steps = 0
    tckpt.restore_checkpoint(path, state)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    assert (state.step, state.nan_steps) == (7, 2)


def test_resume_order_and_epoch(tmp_path, tiny):
    """A step save resumes the same epoch; an end-of-epoch save of the same
    epoch outranks it and resumes the next."""
    state, _ = tiny
    logdir = str(tmp_path)
    tckpt.save_checkpoint(logdir, state, epoch=3, metric=0.2)
    tckpt.save_checkpoint(logdir, state, epoch=4, tag="step1234")
    path = tckpt.latest_checkpoint(logdir)
    assert path.endswith("model_000004_step1234.ckpt")
    assert tckpt.next_epoch_after(path) == 4
    tckpt.save_checkpoint(logdir, state, epoch=4, tag="step99")
    assert tckpt.latest_checkpoint(logdir).endswith("model_000004_step1234.ckpt")
    tckpt.save_checkpoint(logdir, state, epoch=4, metric=0.15)
    path = tckpt.latest_checkpoint(logdir)
    assert path.endswith("model_000004_0.1500.ckpt")
    assert tckpt.next_epoch_after(path) == 5


def test_restore_keeps_an_optimizer_that_does_not_match(tmp_path, tiny):
    state, _ = tiny
    path = tckpt.save_checkpoint(str(tmp_path), state, epoch=0)
    other = create_train_state(state.model, torch.optim.SGD(state.model.parameters(), lr=0.5))
    tckpt.restore_checkpoint(path, other)
    assert other.optimizer.param_groups[0]["lr"] == 0.5 and "alpha" not in \
        other.optimizer.param_groups[0]


def test_trainer_epochs_records_and_resume(tmp_path, tiny):
    state, batch = tiny
    logs = []
    trainer = Trainer(state, model_loss("adamvs"), str(tmp_path), dlossw=(0.5, 1.0),
                      num_stages=2, summary_freq=1, ckpt_step_freq=2, log_fn=logs.append,
                      device="cpu")
    means = trainer.train_epoch(0, [batch, batch])
    val = trainer.eval_epoch(0, [batch])
    trainer.end_epoch(0, val)
    assert np.isfinite(means["loss"]) and state.step == 2
    for k in ("loss", "abs_depth_error", "thres1interval_error", "thres3interval_error"):
        assert np.isfinite(val[k]), k
    names = sorted(os.listdir(tmp_path))
    assert "model_000000_step2.ckpt" in names and "train_record.txt" in names
    assert f"model_000000_{val['abs_depth_error']:.4f}.ckpt" in names
    kinds = [line.split('"kind": ')[1][:7] for line in open(tmp_path / "metrics.jsonl")]
    assert kinds == ['"train"', '"train"', '"val", ']
    fresh = create_train_state(state.model, make_optimizer(state.model.parameters()))
    again = Trainer(fresh, model_loss("adamvs"), str(tmp_path), num_stages=2,
                    log_fn=logs.append, device="cpu")
    assert again.resume() == 1 and fresh.step == 2
    again.load(str(tmp_path / "model_000000_step2.ckpt"))
    assert any("resuming from" in m for m in logs) and any("loading" in m for m in logs)


# --- losses and metrics -------------------------------------------------------------

def _loss_case(empty_stage):
    rng = np.random.RandomState(2)
    B, H, W = 2, 16, 24
    gt = {f"stage{k}": rng.uniform(320, 480, (B, H >> (3 - k), W >> (3 - k))).astype(np.float32)
          for k in (1, 2, 3)}
    mask = {k: (rng.rand(*v.shape) > 0.3).astype(np.float32) for k, v in gt.items()}
    mask[empty_stage][:] = 0.0
    out = {}
    for k, (h, w) in (("stage1", (H // 2, W // 2)), ("stage2", (H, W)), ("stage3", (H, W))):
        d = rng.uniform(320, 480, (B, h, w)).astype(np.float32)
        d[0, 0, 0] += 300.0  # an outlier, on the linear branch of smooth-L1
        pair = tuple(gt["stage1"] + rng.randn(*gt["stage1"].shape).astype(np.float32)
                     for _ in range(3)) if k == "stage1" else ()
        out[k] = {"depth": d, "pair_result": pair}
    return out, gt, mask


@pytest.mark.parametrize("empty_stage", ["stage1", "stage3"])
def test_losses_match_jax(empty_stage):
    out, gt, mask = _loss_case(empty_stage)
    jout = jax.tree_util.tree_map(jnp.asarray, out)
    tout = {k: {"depth": _t(v["depth"]), "pair_result": tuple(_t(p) for p in v["pair_result"])}
            for k, v in out.items()}
    tgt, tmask = {k: _t(v) for k, v in gt.items()}, {k: _t(v) for k, v in mask.items()}
    for jfn, tfn in ((jlosses.cas_mvs_vis_loss, tlosses.cas_mvs_vis_loss),
                     (jlosses.cas_rednet_loss, tlosses.cas_rednet_loss)):
        want = [float(x) for x in jfn(jout, gt, mask, DLOSSW)]
        got = [float(x) for x in tfn(tout, tgt, tmask, DLOSSW)]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(tlosses.masked_mean(_t(gt["stage1"]), torch.zeros(gt["stage1"].shape))) == 0.0
    x = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_allclose(tlosses.smooth_l1(_t(x)).numpy(),
                               np.asarray(jlosses.smooth_l1(jnp.asarray(x))), rtol=1e-6)


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    B, H, W = 3, 13, 17
    gt = (rng.rand(B, H, W) * 100 + 100).astype(np.float32)
    est = gt + rng.randn(B, H, W).astype(np.float32) * 2
    est[0, 0, 0] += 500  # an outlier beyond 100 intervals
    mask = (rng.rand(B, H, W) > 0.2).astype(np.float32)
    mask[2] = 0.0  # an empty mask contributes 0
    interval = np.array([1.5, 0.7, 1.0], np.float32)
    want = jmetrics.eval_metrics(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask),
                                 jnp.asarray(interval))
    got = tmetrics.eval_metrics(_t(est), _t(gt), _t(mask), _t(interval))
    assert want.keys() == got.keys()
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k


# --- learning ---------------------------------------------------------------------

@pytest.mark.slow
def test_tiny_adamvs_learns_depth(tiny, synthetic_scene):
    """200 RMSprop steps on one scene, from the JAX model's own init as the
    JAX package's test_golden.py starts, take the depth error from many
    intervals to under 2 (that test's bar)."""
    from adamvs_tpu_torch.train.jax_import import from_jax_variables

    state, batch = tiny
    jmodel = JAdaMVS(**TINY)
    variables = jmodel.init(jax.random.PRNGKey(0), batch["imgs"], batch["proj_matrices"],
                            batch["depth_values"])
    state.model.load_state_dict(from_jax_variables(variables))
    state.optimizer = make_optimizer(state.model.parameters(), lr=1e-3)
    step = make_train_step(model_loss("adamvs"), (0.5, 1.0))
    tb = to_device(batch, torch.device("cpu"))
    interval = synthetic_scene.depth_interval
    gt, mask = tb["depth"]["stage2"], tb["mask"]["stage2"]

    def err_intervals(depth_est):
        est = torch.nn.functional.interpolate(depth_est[:, None], size=gt.shape[-2:],
                                              mode="bilinear", align_corners=False)[:, 0]
        e = tmetrics.eval_metrics(est, gt, mask, tb["depth_interval"])["abs_depth_error"]
        return float(e) / interval

    _, _, depth = step(state, tb)
    start = err_intervals(depth)
    for _ in range(199):
        _, _, depth = step(state, tb)
    final = err_intervals(depth)
    assert start > 5.0, f"untrained error suspiciously low: {start}"
    assert final < 2.0, f"did not learn depth: {final} intervals after 200 steps"
