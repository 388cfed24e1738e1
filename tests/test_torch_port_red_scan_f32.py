"""K3's float32 form on the CPU (``adamvs_tpu_torch/ops/red_scan.py``,
``csrc/red_scan.cu``, namespace ``f32``).

The float32 kernel runs each depth step as the bf16 kernel does, three
phases of implicit GEMMs, but multiplies in split TF32: every operand x is
hi + lo, each rounded to TF32 as ``cvt.rna.tf32.f32`` rounds, and a product
is a_hi b_lo + a_lo b_hi + a_hi b_hi summed in float32. The host packs the
weights once, already split, in the k8 fragment order
(``pack_red_fragments_tf32``). Here:

- ``tf32_round`` rounds as ``cvt.rna`` does (nearest, ties away from zero);
- the split fragments, read back by the PTX fragment layout, give back every
  convolution's float32 weight within 2^-21 of it, hi and lo each with 13
  zero low mantissa bits, at every input width the kernel takes and both
  regulariser widths;
- a plain model of the three phases with the kernel's 3xTF32 products
  (``three_phase_scan(..., split_tf32=True)``) agrees with ``red_scan_ref``
  and with the JAX ``ada_red_scan`` in float32 in interpret mode within
  1e-5 of the cost's largest magnitude;
- the wrapper's cache packs the float32 weights again after
  ``load_state_dict`` or an RMSprop step.
"""

import numpy as np
import pytest
import torch

from adamvs_tpu_torch.nn.blocks import init_parameters
from adamvs_tpu_torch.nn.costreg import AdaRedCell
from adamvs_tpu_torch.ops.red_scan import (DECONV_TAPS, _packed_weights, pack_red_fragments_tf32,
                                          red_scan_ref, tc_width, tf32_round)
from adamvs_tpu_torch.train.state import (apply_updates_if_finite, create_train_state,
                                          make_optimizer)
from tests.test_torch_port_red_scan import (CASES, _inputs, _jax_red_scan, gemm_weights_tf32,
                                            three_phase_scan, unpack_fragments)

torch.set_num_threads(2)


def _cell(cin: int, base: int, up: bool, seed: int) -> AdaRedCell:
    cell = AdaRedCell(cin, base, up)
    init_parameters(cell, torch.Generator().manual_seed(seed))
    return cell


def _low_bits(t: torch.Tensor) -> int:
    """The largest of the low 13 mantissa bits of float32 ``t``, as an int."""
    return int((t.contiguous().view(torch.int32) & 0x1FFF).max())


def test_tf32_round_is_cvt_rna():
    """To the nearest float32 with 11 significant bits, ties away from zero,
    against a float64 reference; exact ties of both signs included."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4000), rng.randn(1000) * 1e-30, rng.randn(1000) * 1e30])
    x = x.astype(np.float32)
    ties = (x.view(np.int32) & ~np.int32(0x1FFF)) | np.int32(0x1000)  # halfway between two
    x = np.concatenate([x, ties.view(np.float32), [0.0, -0.0]]).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    want = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5) * 2.0 ** (e - 11)
    got = tf32_round(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.astype(np.float64), want)
    assert _low_bits(torch.from_numpy(got)) == 0


def _dense(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """Conv2d weight [co, ci, 3, 3] -> [(ky, kx, 8 groups), co], zero past ci."""
    co, ci = weight.shape[:2]
    out = weight.new_zeros((3, 3, 8 * groups, co))
    out[:, :, :ci] = weight.permute(2, 3, 1, 0)
    return out.reshape(-1, co)


def _assert_split(pair, want: torch.Tensor, name) -> None:
    hi, lo = pair
    assert hi.shape == lo.shape == want.shape, name
    assert _low_bits(hi) == 0 and _low_bits(lo) == 0, name
    err = (hi + lo - want).abs()
    assert bool((err <= 2.0**-21 * want.abs()).all()), (name, float(err.max()))
    assert not (hi + lo)[want == 0].any(), name  # zero padding stays zero


@pytest.mark.parametrize("cin", [4, 8, 16, 20, 32, 40, 64])
@pytest.mark.parametrize("base", [4, 8])
def test_tf32_fragments_split_each_conv_weight(cin, base):
    up = (cin // 4 + base) % 2 == 0
    cell = _cell(cin, base, up, seed=21)
    wts = gemm_weights_tf32(cell)
    convs = {"c1": cell.conv1.conv, "g1": cell.conv_gru1.conv_gates[0],
             "n1": cell.conv_gru1.convc[0], "c2": cell.conv2.conv,
             "g2": cell.conv_gru2.conv_gates[0], "n2": cell.conv_gru2.convc[0]}
    for name, conv in convs.items():
        wt = conv.weight.detach().float()
        ci = wt.shape[1]
        groups = tc_width(ci) // 8 if name == "c1" else -(-ci // 8)
        _assert_split(wts[name], _dense(wt, groups), name)
    up1 = cell.upconv1.weight.detach().float()  # [2b, b, 3, 3]
    for a in (0, 1):
        for c in (0, 1):
            want = torch.cat([torch.cat([up1[:, :, ky, kx], up1.new_zeros(
                (8 * -(-2 * base // 8) - 2 * base, base))])
                for ky in DECONV_TAPS[a] for kx in DECONV_TAPS[c]])
            _assert_split(wts[f"u1_{a}{c}"], want, (a, c))
    # the head and every bias stay float32 as they are
    head = cell.upconv2d.weight.detach().float()
    assert torch.equal(wts["wh"].reshape(base, 3, 3), head[:, 0] if up else head[0])
    for name, conv in (("bg1", convs["g1"]), ("bn1", convs["n1"]), ("bg2", convs["g2"]),
                       ("bn2", convs["n2"]), ("bu1", cell.upconv1), ("bh", cell.upconv2d)):
        assert torch.equal(wts[name], conv.bias.detach().float()), name


def test_fragment_readback_layout():
    """The readback used above inverts the k8 fragment layout: a fragment of
    known entries gives back B[8s + 2(l % 4) + e, 8t + l // 4]."""
    ks, nt = 3, 2
    frag = torch.arange(ks * nt * 32 * 2, dtype=torch.float32).reshape(ks, nt, 32, 2)
    dense = unpack_fragments(frag, 8 * ks, 8 * nt)
    s, t, lane, e = 2, 1, 13, 1
    assert dense[8 * s + 2 * (lane % 4) + e, 8 * t + lane // 4] == frag[s, t, lane, e]


def _rel_to_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("cin,base,up,B", CASES)
def test_tf32_model_matches_plain_k3(cin, base, up, B):
    _, cell, _, tvol = _inputs(cin, base, up, B, seed=22)
    with torch.no_grad():
        want = red_scan_ref(cell, tvol)
        got = three_phase_scan(cell, tvol, split_tf32=True)
    assert got.shape == want.shape
    assert _rel_to_max(got, want) < 1e-5


@pytest.mark.parametrize("cin,base,up,B", [CASES[0], CASES[2], CASES[4]])
def test_tf32_model_matches_jax_kernel(cin, base, up, B):
    import jax.numpy as jnp

    variables, cell, vol, tvol = _inputs(cin, base, up, B, seed=23)
    want = _jax_red_scan(variables, vol, base, up, jnp.float32)
    with torch.no_grad():
        got = three_phase_scan(cell, tvol, split_tf32=True)
    assert got.shape == want.shape
    assert _rel_to_max(got, want) < 1e-5


@pytest.mark.parametrize("how", ["load_state_dict", "rmsprop"])
def test_packed_tf32_weights_repack(how):
    """The float32 key of the wrapper's cache packs again when the weights
    change through ``load_state_dict`` or an RMSprop step of the train loop,
    as a fresh packing packs them, and keeps the bf16 key apart."""
    cell, other = _cell(16, 8, True, seed=24), _cell(16, 8, True, seed=25)
    first = _packed_weights(cell, torch.float32)
    assert _packed_weights(cell, torch.float32) is first
    if how == "load_state_dict":
        cell.load_state_dict(other.state_dict())
    else:
        opt = make_optimizer(cell.parameters())
        for p, q in zip(cell.parameters(), other.parameters()):
            p.grad = q.detach().clone()
        assert apply_updates_if_finite(create_train_state(cell, opt), torch.tensor(1.0))
    again = _packed_weights(cell, torch.float32)
    assert again is not first
    assert not all(torch.equal(a, b) for a, b in zip(again, first))
    assert all(torch.equal(a, b) for a, b in zip(again, pack_red_fragments_tf32(cell)))
    assert _packed_weights(cell, torch.bfloat16) is not again
