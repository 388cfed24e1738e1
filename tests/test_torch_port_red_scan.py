"""K3's tensor-core decomposition on the CPU (``adamvs_tpu_torch/ops/red_scan.py``,
``csrc/red_scan.cu``).

The bf16 kernel runs each depth step as three phases (c1 and GRU1 at full
resolution; the stride-2 c2 and GRU2 at half resolution; the transposed
convolution in four output phases with the skip, and the head), every
convolution an implicit GEMM over K slices ordered (ky, kx, channel) whose
weights ``pack_red_fragments`` lays out in the ``mma`` B-fragment order
(m16n8k8 steps where a tap has one 8-channel slice, m16n8k16 otherwise), and
the GRU states ping-ponging between two buffers. Here:

- the fragments, read back by the PTX fragment layout, give back every
  convolution's weight exactly;
- a plain model of the three phases over whole planes, with GEMMs on those
  read-back weights, equals ``red_scan_ref`` in float32 and the JAX
  ``ada_red_scan`` Pallas kernel in interpret mode;
- the same model with bf16 operands, float32 sums and bf16 carries and cost
  (the kernel's rounding points) matches the JAX kernel's bf16 path;
- the wrapper packs again exactly when the weights change, among them
  the ways the port loads and updates weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adamvs_tpu.ops.red_scan import ada_red_scan, pack_red_params, spatialize
from adamvs_tpu_torch.nn.costreg import AdaRedCell
from adamvs_tpu_torch.ops.red_scan import (DECONV_TAPS, _packed_weights, pack_red_fragments,
                                          pack_red_fragments_tf32, red_scan_ref, tc_width,
                                          tf32_split)
from adamvs_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from adamvs_tpu_torch.train.state import (apply_updates_if_finite, create_train_state,
                                          make_optimizer)
from tests.test_torch_port_nn import _cell_pair

torch.set_num_threads(2)

# (cin, base, up, B): both widths, both heads, the input widths of AdaMVS base 8 and two
# the kernel pads (4 to one 8-channel slice, 20 to four)
CASES = [(16, 8, True, 2), (8, 8, False, 1), (32, 4, True, 1), (16, 4, False, 1),
         (4, 8, False, 2), (20, 4, True, 1)]
H, W, D, TILE_ROWS = 20, 36, 3, 16  # two of the JAX kernel's row tiles, the second ragged


def unpack_fragments(frag: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """B [K, N] from ``mma`` B fragments [k-steps, n-tiles, 32, 2 or 4]: of an
    m16n8k8 step (2 values per lane) lane l's register b0 holds rows
    2(l % 4) + {0, 1} of column l // 4, the lower row in the lower half; of an
    m16n8k16 step (4) b1 holds the 8 rows after them too."""
    f = frag.float().numpy()
    ks, nt, _, per_lane = f.shape
    dense = np.zeros((4 * per_lane * ks, 8 * nt), np.float32)
    for s in range(ks):
        for t in range(nt):
            for lane in range(32):
                for i in range(per_lane):
                    k = 4 * per_lane * s + 2 * (lane % 4) + i % 2 + 8 * (i // 2)
                    dense[k, 8 * t + lane // 4] = f[s, t, lane, i]
    assert not dense[K:].any() and not dense[:, N:].any()  # padding is zero
    return torch.from_numpy(dense[:K, :N])


def _steps(taps: int, channels: int) -> int:
    """mma steps of a GEMM over ``taps`` taps of ``channels`` channels: one
    m16n8k8 per tap of one 8-channel slice, else one m16n8k16 per two slices."""
    g = -(-channels // 8)
    return taps if g == 1 else taps * g // 2


def gemm_weights(cell, dtype) -> dict:
    """The dense GEMM operands B of the kernel's convolutions, read back from
    ``pack_red_fragments``, and its float32 biases and head."""
    b, cin = cell.base, cell.conv1.conv.weight.shape[1]
    packed = pack_red_fragments(cell, dtype)
    out = {}
    for name, frag, ci, co in zip(("c1", "g1", "n1", "c2", "g2", "n2"), packed[:6],
                                  (tc_width(cin), 2 * b, 2 * b, b, 4 * b, 4 * b),
                                  (b, 2 * b, b, 2 * b, 4 * b, 2 * b)):
        out[name] = unpack_fragments(frag, 9 * 8 * -(-ci // 8), co)
    s = 0
    for a in (0, 1):
        for c in (0, 1):
            taps = len(DECONV_TAPS[a]) * len(DECONV_TAPS[c])
            n = _steps(taps, 2 * b)
            out[f"u1_{a}{c}"] = unpack_fragments(packed[6][s:s + n], taps * 8 * -(-2 * b // 8), b)
            s += n
    assert s == packed[6].shape[0]
    out.update(zip(("bg1", "bn1", "bg2", "bn2", "bu1", "wh", "bh"), packed[7:]))
    return out


@pytest.mark.parametrize("cin,base,up,B", CASES)
def test_fragments_unpack_to_each_conv_weight(cin, base, up, B):
    _, _, cell = _cell_pair(cin, base, up, H, W, seed=11)
    cell = cell.to(torch.bfloat16)  # bf16 weights: the packing must give them back bit for bit
    wts = gemm_weights(cell, torch.bfloat16)
    convs = {"c1": cell.conv1.conv, "g1": cell.conv_gru1.conv_gates[0],
             "n1": cell.conv_gru1.convc[0], "c2": cell.conv2.conv,
             "g2": cell.conv_gru2.conv_gates[0], "n2": cell.conv_gru2.convc[0]}
    for name, conv in convs.items():
        wt = conv.weight.float()  # [co, ci, 3, 3]
        co, ci = wt.shape[:2]
        g = tc_width(ci) // 8 if name == "c1" else -(-ci // 8)
        rows = wts[name].reshape(3, 3, g * 8, co)  # K ordered (ky, kx, channel)
        assert torch.equal(rows[:, :, :ci].permute(3, 2, 0, 1), wt), name
        assert not rows[:, :, ci:].any(), name
    up1 = cell.upconv1.weight.float()  # [2b, b, 3, 3]
    for a in (0, 1):
        for c in (0, 1):
            rows = wts[f"u1_{a}{c}"].reshape(len(DECONV_TAPS[a]), len(DECONV_TAPS[c]), -1, base)
            for i, ky in enumerate(DECONV_TAPS[a]):
                for j, kx in enumerate(DECONV_TAPS[c]):
                    assert torch.equal(rows[i, j, :2 * base], up1[:, :, ky, kx]), (a, c, ky, kx)
    # every tap of the transposed convolution lands in exactly one phase
    assert sorted((ky, kx) for a in (0, 1) for c in (0, 1)
                  for ky in DECONV_TAPS[a] for kx in DECONV_TAPS[c]) == [
        (ky, kx) for ky in range(3) for kx in range(3)]
    head = cell.upconv2d.weight.float()  # up: [b, 1, 3, 3]; else [1, b, 3, 3]
    assert torch.equal(wts["wh"].reshape(base, 3, 3), head[:, 0] if up else head[0])
    for name, conv in (("bg1", convs["g1"]), ("bn1", convs["n1"]), ("bg2", convs["g2"]),
                       ("bn2", convs["n2"]), ("bu1", cell.upconv1), ("bh", cell.upconv2d)):
        assert wts[name].dtype == torch.float32 and torch.equal(wts[name], conv.bias.float())


def test_packed_weights_follow_the_parameters():
    """The wrapper packs a cell's weights once and again only after they
    change: in place (an optimizer step), by ``.to``, or for the other dtype."""
    cell = AdaRedCell(16, 8, True)
    first = _packed_weights(cell, torch.bfloat16)
    assert _packed_weights(cell, torch.bfloat16) is first
    with torch.no_grad():
        cell.conv_gru2.convc[0].weight.mul_(2.0)
    again = _packed_weights(cell, torch.bfloat16)
    assert again is not first and torch.equal(again[0], first[0])
    assert torch.equal(again[5].float(), 2 * first[5].float())
    assert len(_packed_weights(cell, torch.float32)) == 14
    moved = cell.to(torch.float64).to(torch.float32)
    assert _packed_weights(moved, torch.bfloat16) is not again


@pytest.mark.parametrize("how", ["load_state_dict", "restore_checkpoint", "rmsprop",
                                 "rmsprop_foreach"])
def test_packed_weights_repack_after_loading_or_updating(how, tmp_path):
    """After a first pack, weights that arrive the ways the port sets them
    (``load_state_dict`` of another cell's or the JAX importer's state dict,
    ``restore_checkpoint``, an RMSprop update of the train loop in either of
    its implementations) are packed again, as a fresh packing packs them."""
    _, _, cell = _cell_pair(16, 8, True, H, W, seed=11)
    _, _, other = _cell_pair(16, 8, True, H, W, seed=12)
    first = _packed_weights(cell, torch.bfloat16)
    if how == "load_state_dict":
        cell.load_state_dict(other.state_dict())
    elif how == "restore_checkpoint":
        path = save_checkpoint(str(tmp_path), create_train_state(
            other, make_optimizer(other.parameters())), epoch=0)
        restore_checkpoint(path, create_train_state(cell, make_optimizer(cell.parameters())))
    else:
        opt = (make_optimizer(cell.parameters()) if how == "rmsprop" else
               torch.optim.RMSprop(cell.parameters(), lr=1e-3, alpha=0.9, foreach=True))
        for p, q in zip(cell.parameters(), other.parameters()):
            p.grad = q.detach().clone()
        assert apply_updates_if_finite(create_train_state(cell, opt), torch.tensor(1.0))
    again = _packed_weights(cell, torch.bfloat16)
    assert again is not first
    assert not all(torch.equal(a, b) for a, b in zip(again, first))
    assert all(torch.equal(a, b) for a, b in zip(again, pack_red_fragments(cell)))


def gemm_weights_tf32(cell) -> dict:
    """The float32 kernel's GEMM operands read back from
    ``pack_red_fragments_tf32``: each convolution's B as the pair (hi, lo)
    of TF32 parts, and its biases and head."""
    b, cin = cell.base, cell.conv1.conv.weight.shape[1]
    packed = pack_red_fragments_tf32(cell)

    def pair(frag, K, N):
        return unpack_fragments(frag[..., :2], K, N), unpack_fragments(frag[..., 2:], K, N)

    out = {}
    for name, frag, ci, co in zip(("c1", "g1", "n1", "c2", "g2", "n2"), packed[:6],
                                  (tc_width(cin), 2 * b, 2 * b, b, 4 * b, 4 * b),
                                  (b, 2 * b, b, 2 * b, 4 * b, 2 * b)):
        out[name] = pair(frag, 9 * 8 * -(-ci // 8), co)
    s = 0
    for a in (0, 1):
        for c in (0, 1):
            taps = len(DECONV_TAPS[a]) * len(DECONV_TAPS[c])
            n = taps * -(-2 * b // 8)  # one m16n8k8 step per tap and 8-channel slice
            out[f"u1_{a}{c}"] = pair(packed[6][s:s + n], taps * 8 * -(-2 * b // 8), b)
            s += n
    assert s == packed[6].shape[0]
    out.update(zip(("bg1", "bn1", "bg2", "bn2", "bu1", "wh", "bh"), packed[7:]))
    return out


def _mm(a: torch.Tensor, b) -> torch.Tensor:
    """a @ b; with b a pair (hi, lo) of TF32 parts, as the float32 kernel
    multiplies: a split as it leaves shared memory, three TF32 products
    a_hi b_lo + a_lo b_hi + a_hi b_hi summed in float32."""
    if not isinstance(b, tuple):
        return a @ b
    hi, lo = b
    a_hi, a_lo = tf32_split(a)
    return a_hi @ lo + a_lo @ hi + a_hi @ hi


def _conv_gemm(x: torch.Tensor, dense: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """3x3 conv (padding 1) of x [B, C, H, W] as the kernel's GEMM: row
    ((ky * 3 + kx) * G + g) * 8 + j of A is channel 8g + j at tap (ky, kx),
    G the 8-channel slices per tap of ``dense``, zero past C."""
    Bn, C, Hi, Wi = x.shape
    c8 = (dense[0] if isinstance(dense, tuple) else dense).shape[0] // 9
    xp = F.pad(x, (1, 1, 1, 1, 0, c8 - C))
    ho, wo = (Hi - 1) // stride + 1, (Wi - 1) // stride + 1
    cols = [xp[:, :, ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(3) for kx in range(3)]
    a = torch.stack(cols, 1).permute(0, 3, 4, 1, 2).reshape(Bn, ho, wo, 9 * c8)
    return _mm(a, dense).permute(0, 3, 1, 2)


def _deconv_phases(x: torch.Tensor, wts: dict, co: int) -> torch.Tensor:
    """Stride-2 ConvTranspose2d(k=3, padding=1, output_padding=1) of x
    [B, C, h, w] without its bias, as four GEMMs: output (2i + a, 2j + c)
    reads tap ky at input row i + (a + 1 - ky) / 2 (oy = 2 iy - 1 + ky)."""
    Bn, C, hi, wi = x.shape
    c8 = 8 * -(-C // 8)
    xp = F.pad(x, (0, 1, 0, 1, 0, c8 - C))  # the input row past the last reads zero
    out = x.new_zeros((Bn, co, 2 * hi, 2 * wi))
    for a in (0, 1):
        for c in (0, 1):
            cols = []
            for ky in DECONV_TAPS[a]:
                for kx in DECONV_TAPS[c]:
                    oy, ox = (a + 1 - ky) // 2, (c + 1 - kx) // 2
                    cols.append(xp[:, :, oy:oy + hi, ox:ox + wi])
            cols = torch.stack(cols, 1).permute(0, 3, 4, 1, 2).reshape(Bn, hi, wi, -1)
            out[:, :, a::2, c::2] = _mm(cols, wts[f"u1_{a}{c}"]).permute(0, 3, 1, 2)
    return out


def three_phase_scan(cell, vol: torch.Tensor, dtype=torch.float32,
                     split_tf32: bool = False) -> torch.Tensor:
    """The kernel's recurrence over whole planes: vol [D,B,cin,h,w] -> cost
    [D,B,oh,ow], float32. Each step runs phase A (c1, GRU1), phase B (c2,
    GRU2) and phase C (u1, head) on GEMMs of the packed weights; step d reads
    the states of parity d % 2 and writes the other, and only parity 0 starts
    at zero. With ``dtype`` bf16 every GEMM operand is rounded to bf16, as are
    the states written and the cost; sums and elementwise work stay float32.
    With ``split_tf32`` (float32) the GEMMs are the float32 kernel's: its
    split weights, and three TF32 products per multiply-add (``_mm``)."""
    def rnd(t):
        return t.to(dtype).float()

    wts = gemm_weights_tf32(cell) if split_tf32 else gemm_weights(cell, dtype)
    b = cell.base
    Dn, Bn, _, hi, wi = vol.shape
    h1 = [torch.zeros((Bn, b, hi, wi)), None]
    h2 = [torch.zeros((Bn, 2 * b, hi // 2, wi // 2)), None]
    costs = []
    for d in range(Dn):
        p, q = d % 2, 1 - d % 2
        # phase A
        c1 = rnd(torch.relu(_conv_gemm(rnd(vol[d].float()), wts["c1"])))
        g = torch.sigmoid(_conv_gemm(torch.cat([c1, h1[p]], 1), wts["g1"]) + wts["bg1"][:, None, None])
        r, u = g[:, :b], g[:, b:]
        c = torch.tanh(_conv_gemm(torch.cat([c1, rnd(r * h1[p])], 1), wts["n1"])
                       + wts["bn1"][:, None, None])
        h1[q] = rnd(u * h1[p] + (1 - u) * c)
        # phase B
        c2 = rnd(torch.relu(_conv_gemm(h1[q], wts["c2"], stride=2)))
        g = torch.sigmoid(_conv_gemm(torch.cat([c2, h2[p]], 1), wts["g2"]) + wts["bg2"][:, None, None])
        r, u = g[:, :2 * b], g[:, 2 * b:]
        c = torch.tanh(_conv_gemm(torch.cat([c2, rnd(r * h2[p])], 1), wts["n2"])
                       + wts["bn2"][:, None, None])
        h2[q] = rnd(u * h2[p] + (1 - u) * c)
        # phase C
        u1 = rnd(torch.relu(_deconv_phases(h2[q], wts, b) + wts["bu1"][:, None, None] + h1[q]))
        head = wts["wh"].reshape(b, 3, 3)
        if cell.up:
            cost = F.conv_transpose2d(u1, head[:, None], wts["bh"], stride=2, padding=1,
                                      output_padding=1)
        else:
            cost = F.conv2d(u1, head[None], wts["bh"], padding=1)
        costs.append(rnd(cost[:, 0]))
    return torch.stack(costs)


def _inputs(cin, base, up, B, seed):
    jcell, variables, cell = _cell_pair(cin, base, up, H, W, seed=seed)
    vol = np.random.RandomState(seed + 1).randn(D, B, H, W, cin).astype(np.float32)
    return variables, cell, vol, torch.from_numpy(vol).permute(0, 1, 4, 2, 3).contiguous()


def _jax_red_scan(variables, vol: np.ndarray, base: int, up: bool, dtype) -> torch.Tensor:
    """The JAX Pallas kernel in interpret mode, as tests/test_red_scan.py runs it."""
    v = jnp.asarray(vol).astype(dtype)
    got = ada_red_scan(pack_red_params(variables["params"], up), spatialize(v, TILE_ROWS),
                       vol.shape[-1], base, up, H, W, tile_rows=TILE_ROWS, interpret=True)
    return torch.from_numpy(np.array(got.astype(jnp.float32)))


@pytest.mark.parametrize("cin,base,up,B", CASES)
def test_three_phase_model_matches_plain_k3(cin, base, up, B):
    _, cell, _, tvol = _inputs(cin, base, up, B, seed=12)
    with torch.no_grad():
        want = red_scan_ref(cell, tvol)
        got = three_phase_scan(cell, tvol)
    assert got.shape == want.shape == (D, B, 2 * H if up else H, 2 * W if up else W)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,base,up,B", CASES)
def test_three_phase_model_matches_jax_kernel(cin, base, up, B):
    variables, cell, vol, tvol = _inputs(cin, base, up, B, seed=13)
    want = _jax_red_scan(variables, vol, base, up, jnp.float32)
    with torch.no_grad():
        got = three_phase_scan(cell, tvol)
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    scale = float(want.std()) + 1e-9
    assert err / scale < 5e-5, (err, scale)  # tests/test_red_scan.py's float32 tolerance


@pytest.mark.parametrize("cin,base,up,B", [CASES[0], CASES[3]])
def test_three_phase_model_bf16_matches_jax_bf16(cin, base, up, B):
    variables, cell, vol, tvol = _inputs(cin, base, up, B, seed=14)
    want = _jax_red_scan(variables, vol, base, up, jnp.bfloat16)
    with torch.no_grad():
        got = three_phase_scan(cell, tvol, torch.bfloat16)
    err = float((got - want).abs().max())
    scale = float(want.std()) + 1e-9
    assert err / scale < 0.08, (err, scale)  # tests/test_red_scan.py::test_red_scan_bf16's
