"""Port nn modules against the JAX package at float32 on the CPU: the feature
net, the stage-1 ``CostRegNet2D``, one ``AdaRedCell`` step (up and not), and
the plain K3 (``red_scan_ref``, the cell stepped over depth) against the JAX
cell scanned over depth. Weights come from a JAX init (BatchNorm statistics
randomised so a swapped mapping cannot cancel out), carried over by the
port's own inverse weight tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adamvs_tpu.nn.costreg import AdaRedCell as JAdaRedCell
from adamvs_tpu.nn.costreg import CostRegNet2D as JCostRegNet2D
from adamvs_tpu.nn.featurenet import AdaFeatureNet as JAdaFeatureNet
from adamvs_tpu.train.torch_import import jax_to_mutable
from adamvs_tpu_torch.nn.costreg import AdaRedCell, CostRegNet2D
from adamvs_tpu_torch.nn.featurenet import AdaFeatureNet
from adamvs_tpu_torch.ops.red_scan import red_scan, red_scan_ref
from adamvs_tpu_torch.train import jax_import

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize_bn(variables, seed):
    """Random BatchNorm scale/bias/mean/var in a flax variables tree."""
    rng = np.random.RandomState(seed)
    v = jax_to_mutable(variables)

    def walk(params, stats):
        for k, node in params.items():
            if "scale" in node and k.startswith("BatchNorm"):
                node["scale"] = (1 + 0.3 * rng.randn(*node["scale"].shape)).astype(np.float32)
                node["bias"] = (0.3 * rng.randn(*node["bias"].shape)).astype(np.float32)
                stats[k]["mean"] = (0.3 * rng.randn(*stats[k]["mean"].shape)).astype(np.float32)
                stats[k]["var"] = (0.5 + rng.rand(*stats[k]["var"].shape)).astype(np.float32)
            elif isinstance(node, dict) and k in stats:
                walk(node, stats[k])

    walk(v["params"], v.get("batch_stats", {}))
    return v


def _port_state(params, stats, plan):
    sd = {}
    jax_import._apply_plan(params, stats, "", plan, sd)
    return sd


def test_feature_net_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    jnet = JAdaFeatureNet(4)
    init = jax.jit(jnet.init, static_argnums=2)
    variables = _randomize_bn(init(jax.random.PRNGKey(0), jnp.asarray(x), False), 1)
    want = jax.jit(jnet.apply, static_argnums=2)(variables, jnp.asarray(x), False)
    net = AdaFeatureNet(4).eval()
    net.load_state_dict(_port_state(variables["params"], variables["batch_stats"],
                                    jax_import._feature_plan()))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("stage1", "stage2", "stage3"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_cost_reg_net_2d_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 32, 40, 8).astype(np.float32)  # depth 8 as channels
    jnet = JCostRegNet2D(8)
    init = jax.jit(jnet.init, static_argnums=2)
    variables = _randomize_bn(init(jax.random.PRNGKey(1), jnp.asarray(x), False), 3)
    want = np.asarray(jax.jit(jnet.apply, static_argnums=2)(variables, jnp.asarray(x), False))
    net = CostRegNet2D(8).eval()
    net.load_state_dict(_port_state(variables["params"], variables["batch_stats"],
                                    jax_import._reg2d_plan()))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _cell_pair(cin, base, up, h, w, seed):
    jcell = JAdaRedCell(base, up)
    carry = jcell.init_carry(1, h, w)
    variables = jax.jit(jcell.init)(jax.random.PRNGKey(seed), carry, jnp.zeros((1, h, w, cin)))
    cell = AdaRedCell(cin, base, up).eval()
    plan = [(t, f.removeprefix("cell/"), k) for t, f, k in jax_import._reg_fuse_plan(up)]
    cell.load_state_dict(_port_state(variables["params"], {}, plan))
    return jcell, variables, cell


@pytest.mark.parametrize("up", [True, False])
def test_ada_red_cell_step_matches_jax(up):
    cin, base, B, h, w = 16, 4, 2, 32, 40
    jcell, variables, cell = _cell_pair(cin, base, up, h, w, seed=4)
    rng = np.random.RandomState(5)
    x = rng.randn(B, h, w, cin).astype(np.float32)
    h1 = rng.randn(B, h, w, base).astype(np.float32)
    h2 = rng.randn(B, h // 2, w // 2, 2 * base).astype(np.float32)
    (jh1, jh2), jout = jax.jit(jcell.apply)(variables, (jnp.asarray(h1), jnp.asarray(h2)),
                                            jnp.asarray(x))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    with torch.no_grad():
        (th1, th2), tout = cell((nchw(h1), nchw(h2)), nchw(x))
    assert tout.shape == ((B, 1, 2 * h, 2 * w) if up else (B, 1, h, w))
    for got, want in ((th1, jh1), (th2, jh2), (tout, jout)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cin,base,up,D", [(8, 8, True, 5), (16, 4, False, 4)])
def test_red_scan_ref_matches_jax_scan(cin, base, up, D):
    """Plain K3 (and the K3 wrapper on CPU tensors) against the JAX cell
    scanned over D from zero states."""
    B, h, w = 1, 32, 36
    jcell, variables, cell = _cell_pair(cin, base, up, h, w, seed=6)
    vol = np.random.RandomState(7).randn(D, B, h, w, cin).astype(np.float32)

    def step(carry, x):
        carry, cost = jcell.apply(variables, carry, x)
        return carry, cost[..., 0]

    _, want = jax.jit(lambda c, v: jax.lax.scan(step, c, v))(jcell.init_carry(B, h, w),
                                                            jnp.asarray(vol))
    tvol = torch.from_numpy(vol).permute(0, 1, 4, 2, 3).contiguous()  # [D,B,C,h,w]
    with torch.no_grad():
        got = red_scan_ref(cell, tvol)
        via_wrapper = red_scan(cell, tvol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(via_wrapper, got)
