"""The port's ``nn/extras.py`` blocks, float64 warp grid, ``depth_regression``,
``windowed_depth_samples`` and checkpoint helpers against the JAX package's.

Each block gets the weights of a seeded flax block (jittered away from its
init, so biases, norms and the deformable heads are non-zero) through
``train/jax_import.py::from_jax_extras`` and the same seeded numpy input;
forward within 1e-5 of max|JAX|, and the gradients of ``Σ y·g`` for a
seeded cotangent ``g`` (input and every parameter) within 1e-4 of each
gradient's max|JAX|. The float64 grid is held to JAX's under x64 at an
aerial geometry (UTM-sized camera centres) where the float32 grid lands a
pixel away."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.nn import extras as jextras
from adamvs_tpu.ops import regression as jregression
from adamvs_tpu.ops import sampling as jsampling
from adamvs_tpu.ops.warp import plane_sweep_warp as jax_plane_sweep_warp
from adamvs_tpu.train import checkpoint as jckpt
from adamvs_tpu_torch import ops
from adamvs_tpu_torch.nn import extras
from adamvs_tpu_torch.ops.warp import plane_sweep_warp, sweep_coords
from adamvs_tpu_torch.train import checkpoint as tckpt
from adamvs_tpu_torch.train.jax_import import from_jax_extras
from adamvs_tpu_torch.train.state import create_train_state, make_optimizer

FWD, GRAD = 1e-5, 1e-4


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """NHWC (NDHWC) numpy -> NCHW (NCDHW) tensor."""
    return torch.tensor(np.moveaxis(a, -1, 1))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _variables(jblock, seed: int, *args):
    """Seeded flax variables of ``jblock`` for inputs ``args``, none at their
    init value: kernels N(0, 1/fan_in), norm scales and running variances
    1 + 0.3·|N|, biases and running means 0.3·N."""
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def value(path, leaf):
        z = rng.randn(*leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        if name in ("scale", "var"):
            return 1 + 0.3 * np.abs(z)
        return 0.3 * z

    return jax.tree_util.tree_map_with_path(value, shapes)


def _vjp(fn, seed: int, *primals):
    """(output, aux, the gradients of Σ output·g for each primal, g) of
    ``fn(*primals) -> (output, aux)`` in one jitted call, g seeded."""
    out_shape = jax.eval_shape(fn, *primals)[0]
    g = np.random.RandomState(seed).randn(*out_shape.shape).astype(np.float32)

    @jax.jit
    def run(*primals):
        y, vjp, aux = jax.vjp(fn, *primals, has_aux=True)
        return y, aux, vjp(g)

    y, aux, grads = run(*primals)
    return np.asarray(y), aux, grads, g


def _check_block(jblock, block, x: np.ndarray, train: bool = False, seed: int = 0,
                 grads: bool = True):
    """Forward, updated BatchNorm statistics and (with ``grads``) the
    gradients of one block against its flax twin."""
    variables = _variables(jblock, seed, x)
    stats = variables.get("batch_stats", {})
    block.load_state_dict(from_jax_extras(block, variables))
    block.train(train)
    kw = {"train": train} if isinstance(block, extras.ConvBn3D) else {}

    def apply(params, x):
        v = {"params": params, "batch_stats": stats}
        if train and stats:
            return jblock.apply(v, x, mutable=["batch_stats"], **kw)
        return jblock.apply(v, x, **kw), {}

    if grads:
        y, updates, (gp, gx), g = _vjp(apply, seed + 1, variables["params"], x)
    else:
        y, updates = jax.jit(apply)(variables["params"], x)
    xt = _to_torch(x).requires_grad_(grads)
    yt = block(xt)
    assert _to_numpy(yt).shape == y.shape
    assert _rel(_to_numpy(yt), y) < FWD
    if updates:
        new = from_jax_extras(block, {"params": variables["params"], **updates})
        running = [(n, b) for n, b in block.named_buffers() if "running" in n]
        assert running
        for name, buf in running:
            assert _rel(buf.numpy(), new[name].numpy()) < FWD, name
    if not grads:
        return
    (yt * _to_torch(g)).sum().backward()
    assert _rel(_to_numpy(xt.grad), gx) < GRAD
    want = from_jax_extras(block, {"params": gp, "batch_stats": stats})
    names = dict(block.named_parameters())
    assert names.keys() <= want.keys() and names
    for name, p in names.items():
        assert _rel(p.grad.numpy(), want[name].numpy()) < GRAD, name


# (size, stride, with ReLU): each size at each stride; SAME pads an even size (0, 1) at stride 2
@pytest.mark.parametrize("hw,stride,relu", [((10, 14), 1, True), ((9, 13), 1, False),
                                            ((10, 14), 2, False), ((9, 13), 2, True)])
def test_conv_gn_blocks(hw, stride, relu):
    x = np.random.RandomState(3).randn(2, *hw, 5).astype(np.float32)
    jcls, cls = (jextras.ConvGnReLU, extras.ConvGnReLU) if relu else (jextras.ConvGn, extras.ConvGn)
    _check_block(jcls(features=16, stride=stride), cls(5, 16, stride=stride), x)


@pytest.mark.parametrize("hw,kernel", [((10, 14), 3), ((9, 13), 3), ((9, 13), 4)])
def test_conv_trans_gn_relu(hw, kernel):
    """flax's SAME ConvTranspose, stride 2: exactly 2x at odd and even sizes
    (kernel 4 pads the dilated input evenly, kernel 3 not)."""
    x = np.random.RandomState(4).randn(2, *hw, 6).astype(np.float32)
    block = extras.ConvTransGnReLU(6, 12, kernel=kernel, group_channel=4)
    _check_block(jextras.ConvTransGnReLU(features=12, kernel=kernel, group_channel=4), block, x)
    assert block(_to_torch(x)).shape[2:] == (2 * hw[0], 2 * hw[1])


# (size, stride, train mode, with ReLU): every pair of size, stride and mode once
@pytest.mark.parametrize("dhw,stride,train,relu", [
    ((6, 8, 10), 1, False, True), ((5, 9, 11), 1, True, False),
    ((6, 8, 10), 2, True, True), ((5, 9, 11), 2, False, False)])
def test_conv_bn_3d_blocks(dhw, stride, train, relu):
    x = np.random.RandomState(5).randn(2, *dhw, 3).astype(np.float32)
    jcls, cls = ((jextras.ConvBnReLU3D, extras.ConvBnReLU3D) if relu
                 else (jextras.ConvBn3D, extras.ConvBn3D))
    _check_block(jcls(features=4, stride=stride), cls(3, 4, stride=stride), x, train=train)


@pytest.mark.parametrize("modulated", [True, False])
def test_deform_conv_block(modulated):
    """Non-zero offsets and mask: taps at fractional positions and outside
    the image; the gradients reach the offset head through the positions."""
    x = np.random.RandomState(6).randn(2, 9, 12, 4).astype(np.float32)
    jblock = jextras.DeformConvBlock(features=7, modulated=modulated)
    block = extras.DeformConvBlock(4, 7, modulated=modulated)
    _check_block(jblock, block, x, seed=7)
    off = block.offset(extras._pad_same(_to_torch(x), 3, 1))
    assert off.abs().max() > 2.0 and (off.frac().abs() > 0.05).float().mean() > 0.9


def test_deform_conv_gn_relu():
    """Forward only: its deformable conv's gradients are held above."""
    x = np.random.RandomState(8).randn(1, 8, 10, 3).astype(np.float32)
    _check_block(jextras.DeformConvGnReLU(features=8), extras.DeformConvGnReLU(3, 8), x, seed=9,
                 grads=False)


def test_deform_conv_block_starts_as_a_conv():
    """Zero-initialised heads: a plain 3x3 conv through ``proj`` with every
    tap halved by the mask's sigmoid(0)."""
    torch.manual_seed(0)
    block = extras.DeformConvBlock(3, 5)
    x = torch.randn(1, 3, 7, 9)
    w = block.proj.weight[:, :, 0, 0].reshape(5, 9, 3).permute(0, 2, 1).reshape(5, 3, 3, 3)
    want = torch.nn.functional.conv2d(x, 0.5 * w, block.proj.bias, padding=1)
    torch.testing.assert_close(block(x), want, rtol=1e-5, atol=1e-5)


def test_conv_lstm_cell_two_steps():
    """Two steps from ``init_carry``: both states, and the gradients of the
    second output through both steps."""
    xs = np.random.RandomState(10).randn(2, 2, 8, 11, 4).astype(np.float32)
    jcell = jextras.ConvLSTMCell(hidden=6)
    carry0 = jcell.init_carry(2, 8, 11)
    variables = _variables(jcell, 1, carry0, xs[0])

    def run(params, xs):
        carry = carry0
        outs = []
        for x in xs:
            carry, h = jcell.apply({"params": params}, carry, x)
            outs.append(carry)
        return h, outs

    _, outs, (gp, gx), g = _vjp(run, 2, variables["params"], xs)

    cell = extras.ConvLSTMCell(4, 6)
    cell.load_state_dict(from_jax_extras(cell, variables))
    xt = torch.tensor(np.moveaxis(xs, -1, 2)).requires_grad_(True)
    carry = cell.init_carry(2, 8, 11)
    assert all(c.shape == (2, 6, 8, 11) and not c.any() for c in carry)
    for step in range(2):
        carry, h = cell(carry, xt[step])
        assert h is carry[1]
        for got, want in zip(carry, outs[step]):
            assert _rel(_to_numpy(got), want) < FWD
    (h * _to_torch(g)).sum().backward()
    assert _rel(np.moveaxis(xt.grad.numpy(), 2, -1), gx) < GRAD
    want = from_jax_extras(cell, {"params": gp})
    for name, p in cell.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) < GRAD, name


def _aerial_projs(H: int, W: int):
    """Reference and source projections of a nadir pair with UTM-sized
    camera centres, 10 cm apart, the source turned by 1e-4 rad."""
    def proj(centre, angle, f=4.0e4):
        k = np.eye(4)
        k[0, 0] = k[1, 1] = f
        k[0, 2], k[1, 2] = W / 2, H / 2
        rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                        [0, 0, 1]])
        ext = np.eye(4)
        ext[:3, :3] = rot
        ext[:3, 3] = -rot @ np.asarray(centre)
        return (k @ ext).astype(np.float32)[None]
    return proj([5.0e5 + 0.1, 4.0e6 + 0.05, -1000.0], 1e-4), proj([5.0e5, 4.0e6, -1000.0], 0.0)


def test_float64_grid_matches_jax():
    """``grid_dtype=torch.float64`` against JAX's ``grid_dtype=jnp.float64``
    under x64 (1e-6 of max|JAX|); the float32 grid misses it by far more, so
    the float64 path really ran."""
    H, W = 24, 32
    feat = np.random.RandomState(11).rand(1, H, W, 3).astype(np.float32)
    src, ref = _aerial_projs(H, W)
    depth = np.linspace(1000.0, 1004.0, 4, dtype=np.float32)[None]
    with jax.enable_x64(True):
        want = np.asarray(jax_plane_sweep_warp(feat, src, ref, depth, grid_dtype=jnp.float64))
    assert want.dtype == np.float32 and (want != 0).mean() > 0.5
    args = [torch.tensor(a) for a in (feat, src, ref, depth)]
    got = plane_sweep_warp(*args, grid_dtype=torch.float64)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-6
    assert _rel(plane_sweep_warp(*args).numpy(), want) > 1e-2
    u, v = sweep_coords(*args, grid_dtype=torch.float64)
    u32, v32 = sweep_coords(*args)
    assert u.dtype == torch.float32 and max((u - u32).abs().max(), (v - v32).abs().max()) > 0.5


@pytest.mark.parametrize("per_pixel", [False, True])
def test_depth_regression(per_pixel):
    rng = np.random.RandomState(12)
    prob = rng.rand(2, 6, 12, 16).astype(np.float32)
    prob /= prob.sum(axis=1, keepdims=True)
    shape = (2, 6, 6, 8) if per_pixel else (2, 6)
    dv = (300 + 200 * rng.rand(*shape)).astype(np.float32)
    want = np.asarray(jregression.depth_regression(jnp.asarray(prob), jnp.asarray(dv)))
    got = ops.depth_regression(torch.tensor(prob), torch.tensor(dv))
    assert got.shape == (2, 12, 16)
    assert _rel(got.numpy(), want) < FWD


def test_windowed_depth_samples():
    rng = np.random.RandomState(13)
    prev = (300 + 200 * rng.rand(2, 5, 7)).astype(np.float32)
    for interval in (2.5, (1 + rng.rand(2, 5, 7)).astype(np.float32)):
        want = np.asarray(jsampling.windowed_depth_samples(jnp.asarray(prev), 8, interval))
        it = torch.tensor(interval) if isinstance(interval, np.ndarray) else interval
        got = ops.windowed_depth_samples(torch.tensor(prev), 8, it)
        assert got.shape == (2, 8, 5, 7)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_checkpoint_epoch_matches_jax():
    for name in ("model_000000", "model_000019_0.1339", "model_000004_step1234",
                 "model_000012_0.0999_step7", "checkpoint", "model_12"):
        assert tckpt.checkpoint_epoch(f"/logs/{name}.ckpt") == jckpt.checkpoint_epoch(
            f"/logs/{name}")


def _state(seed: int, optimizer: str = "rmsprop"):
    torch.manual_seed(seed)
    model = extras.ConvGnReLU(3, 8)
    opt = (make_optimizer(model.parameters()) if optimizer == "rmsprop"
           else torch.optim.SGD(model.parameters(), lr=0.5))
    model(torch.randn(1, 3, 6, 6)).sum().backward()
    opt.step()
    return create_train_state(model, opt)


@pytest.mark.parametrize("restore_opt", [None, True, False])
def test_restore_opt_modes(tmp_path, restore_opt):
    """None restores the optimizer when it fits, True always (raising when it
    does not fit), False never; the model and counters always."""
    saved = _state(0)
    saved.step, saved.nan_steps = 11, 3
    path = tckpt.save_checkpoint(str(tmp_path), saved, epoch=2, metric=0.5)
    assert tckpt.checkpoint_epoch(path) == 2
    state = _state(1)
    tckpt.restore_checkpoint(path, state, restore_opt=restore_opt)
    for k, v in saved.model.state_dict().items():
        torch.testing.assert_close(state.model.state_dict()[k], v, rtol=0, atol=0)
    assert (state.step, state.nan_steps) == (11, 3)
    got = state.optimizer.state_dict()["state"]
    want = (saved if restore_opt is not False else _state(1)).optimizer.state_dict()["state"]
    for k in want:
        torch.testing.assert_close(got[k]["square_avg"], want[k]["square_avg"], rtol=0, atol=0)

    other = _state(2, "sgd")
    if restore_opt:
        with pytest.raises(ValueError, match="does not fit"):
            tckpt.restore_checkpoint(path, other, restore_opt=restore_opt)
    else:
        tckpt.restore_checkpoint(path, other, restore_opt=restore_opt)
        assert other.optimizer.param_groups[0]["lr"] == 0.5
        torch.testing.assert_close(other.model.conv.weight, saved.model.conv.weight)
