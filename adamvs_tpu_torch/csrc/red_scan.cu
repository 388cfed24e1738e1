// The AdaRedCell recurrence over depth: kernel K3.
//
// Replaces the Pallas kernel adamvs_tpu/ops/red_scan.py::_red_scan_kernel
// (:348), called through ada_red_scan (:542, pallas_call :591). For every
// depth slice d of the fused volume, in order:
//   c1 = relu(conv3x3(x_d))                        cin -> b
//   h1 = GRU(h1, c1)                               b, at h x w
//   c2 = relu(conv3x3 stride 2(h1))                b -> 2b, at h/2 x w/2
//   h2 = GRU(h2, c2)                               2b, at h/2 x w/2
//   u1 = relu(deconv stride 2(h2) + bias + h1)     2b -> b, at h x w
//   cost_d = deconv stride 2(u1) + bias (up)  or  conv3x3(u1) + bias
// where GRU(h, x): r, u = sigmoid(conv([x, h]) + b_g); c = tanh(conv([x, r*h])
// + b_c); h' = u*h + (1-u)*c. Convolutions use PyTorch padding 1; the
// transposed convolutions follow ConvTranspose2d(k=3, stride=2, padding=1,
// output_padding=1): output pixel oy reads input iy = (oy + 1 - ky) / 2 where
// that is whole, so the output is exactly 2x.
//
// What bounds it on an H100: operations. The step's convolutions do about
// 8.7k multiply-adds per pixel of the h x w level at base 8, against a few
// bytes per pixel of input and output: 1.7e12 flops per AdaMVS depth map,
// 1.7 ms on the bf16 tensor cores, 25 ms as float32 FMAs, and 10.2 ms in
// float32 on the TF32 tensor cores at three products per multiply-add
// (3xTF32, 495 / 3 TFLOP/s), the float32 form's roof.
//
// bfloat16 (the inference path): three launches per depth step, each tiled
// over the image and fused, every 3x3 and stride-2 convolution an implicit
// GEMM on the tensor cores (mma.sync m16n8k16 and m16n8k8, bf16 operands,
// float32 sums); blocks of 8 warps, two or more blocks per SM:
//   phase A, full resolution, 16x16 tiles (16x32 at 8 input channels): x_d on the tile
//     plus 3 pixels and h1 on the tile plus 2 go to shared memory; c1 on the
//     tile plus 2, the gates on the tile plus 1 (r*h1 kept beside c1, u on
//     the tile), the candidate on the tile; h1' is written.
//   phase B, half resolution, 16x16 tiles: h1' on the tile's full-resolution
//     footprint plus 5 (and 4) pixels, h2 on the tile plus 2; the stride-2 c2,
//     GRU2 as in phase A; h2' is written.
//   phase C, full resolution, 16x32 tiles (32x32 under the 3x3 head): h2'
//     and h1' around the tile; u1 on the tile plus 1 as the four output phases
//     of the transposed convolution (1, 2, 2 and 4 taps); the head on the CUDA
//     cores (N = 1, 72 multiply-adds per pixel; the 2x head one 2x2 output
//     quad per thread); the cost slice is written.
// Each launch reads only the carries and the volume slice and writes only the
// carries and the cost; every tile recomputes its own halo ring. A launch
// boundary is the grid-wide barrier between phases. The GEMM: M = a region's
// pixels in 16-row tiles, each warp taking all of its tiles at once; N =
// output channels in tiles of 8; K = taps x channels ordered (ky, kx, ci), in
// slices of 8 channels of one tap, so that one pixel's 8 channels are one
// 16-byte row of an ldmatrix; a row's pixel and tap give its shared-memory
// address, which makes the stride and the transposed convolutions mere
// addressing. The host packs the weights once per call into the mma
// B-fragment order (ops/red_scan.py::pack_red_fragments); warps read them
// through L1. Sigmoid, tanh (tanh.approx), the GRU update, ReLU and the skip
// run in float32 registers in the GEMM's epilogue. Operands round to bf16
// where they enter a GEMM, as the TPU kernel casts them at its MXU inputs;
// the carries and the cost are stored in bf16. The GRU states arrive by
// cp.async while the first GEMM of the phase runs.
//
// Why the carries ping-pong: the phases read neighbouring tiles' states, so a
// step cannot update h1 or h2 in place; step d reads parity d&1 and writes
// parity 1-(d&1), as the TPU kernel does with its two HBM buffers. Step 0
// reads zero states without touching the buffers. Carries are NHWC bf16 in
// the kernel's own scratch: 2 x (B h w b + B h/2 w/2 2b) values.
//
// Traps, and what the code does about them:
//   - conv zero padding: every intermediate in a halo ring outside the image
//     (c1, c2, u1) is zeroed before the next convolution reads it, since a
//     ReLU, a bias or even a bias-free conv whose taps reach into the image
//     is nonzero there; r*h is zero there because h is loaded as zero.
//   - the transposed-convolution index map oy = 2 iy - 1 + ky: an even output
//     row reads tap ky=1 at iy = oy/2, an odd one ky=2 at (oy-1)/2 and ky=0 at
//     (oy+1)/2 (DeconvTaps; the packing follows the same tap order).
//   - shared memory above 48 KB: cudaFuncSetAttribute before the launches.
//   - ldmatrix rows must be 16-byte aligned: pixel rows are a whole number of
//     16-byte units, padded to an odd number (pitch()) so that the 8 rows of
//     one 8x8 matrix, 8 neighbouring pixels, fall in distinct banks.
//   - h and w need not be multiples of a tile: loads zero-fill outside the
//     image and stores skip it. h and w must be even (the half level).
//   - base 4: 4-channel tensors are zero-padded to one 8-channel slice. The
//     volume's cin channels likewise go to shared memory as CP = 8, 16, 32 or
//     64 channels, the next of them, loaded as zero past cin; conv1's packed
//     weights have zero rows there (ops/red_scan.py::tc_width).
//   - registers: weight loads do not depend on the M tiles, so with a loop
//     over tiles the compiler hoists them all out of it (144 registers for
//     GRU2's gates, and spills); hence no loop: a warp's tiles are unrolled.
//
// float32 (the trainer's eval step, predict in float32 with the fused sweep,
// the float32 checks): the same three phases, tiles and ping-pong in float32
// (namespace f32), every convolution an implicit GEMM on the TF32 tensor
// cores in split TF32: x = hi + lo, hi = x rounded to TF32 (as cvt.rna), lo =
// x - hi rounded to TF32 too (left unrounded, the mma would truncate it: a
// bias that 48 recurrent steps compound), and a product is a_hi b_lo + a_lo
// b_hi + a_hi b_hi in float32 sums (mma.sync m16n8k8 .tf32), an error of
// about 2^-21 of a product, as JAX's Precision.HIGHEST on the MXU; one-pass
// TF32 would break the form's 1e-4 agreement. One k8 step is one 8-channel
// slice of one tap, K ordered (ky, kx, ci) as in bf16, with the channels of
// a slice permuted (k = q holds channel 2q, k = q + 4 channel 2q + 1) so
// that a lane's A elements of a row are one 8-byte shared load, at pixel
// pitches whose 4 consecutive pixels fall in distinct 8-bank groups (pitch(),
// kPitchS2 for the stride-2 input). The host packs the weights once, already
// split, in the k8 fragment order (ops/red_scan.py::pack_red_fragments_tf32):
// one 16-byte load per lane, step and n-tile gives b_hi and b_lo. A is split
// as it leaves shared memory, in integer operations (tf32, tf32_operand),
// shared by the n-tiles. Shared memory and the carries stay float32, so the
// windows double against bf16; each phase reuses the window of its first
// GEMM's input (x, or h1' at half resolution) for [c | r*h] and u once that
// GEMM is done, the gates' epilogue copying c across. Phase A takes 16x16
// tiles up to 16 input channels and 8x16 above; phases B and C take 8x16
// half-resolution and 16x32 (32x32 under the 3x3 head) tiles where those give
// every SM a block, else 4x8 and 8x16, so that the eval step's 96x192 first
// stage still fills the card (make_plan; the plan entry reports grids, shared
// memory and blocks per SM). A GEMM's M tiles go to the warps in two passes,
// so that no warp runs a tile past M and no mma sits behind a per-tile test
// (gemm). The epilogue stays float32: expf for the sigmoid and tanhf, not
// tanh.approx. Carries are NHWC float32, 2 x (B h w b + B h/2 w/2 2b) values.
// What bounds it on the card is the mma.sync issue of three TF32 products per
// multiply-add and the A traffic of N = 8 GEMMs (one split A fragment feeds
// 3 mma), not the 3xTF32 roof: wgmma would be the next step (PERF.md).
//
// The TPU kernel's band layout, lane-sparse half-resolution level and panel
// loop are Mosaic workarounds and are not copied.
//
// Layouts at the interface: vol [D,B,cin,h,w], cost [D,B,oh,ow].

#include "common.cuh"

namespace {

// ------------------------------------------------- bfloat16, tensor cores --

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Elements per shared-memory pixel row of cp channels (cp % 8 == 0): an odd
// number of 16-byte units, so 8 neighbouring pixels hit 8 distinct bank groups.
__host__ __device__ constexpr int pitch(int cp) { return (cp / 8) % 2 ? cp : cp + 8; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tap set: n taps; tap t reads the input pixel (base_y + dy(t), base_x + dx(t)).
struct Conv3Taps {
  static constexpr int n = 9;
  __host__ __device__ static constexpr int dy(int t) { return t / 3; }
  __host__ __device__ static constexpr int dx(int t) { return t % 3; }
};

// Output phase (A, C) of the stride-2 transposed convolution, A and C the
// parities of the output row and column: an even output row 2i reads tap ky=1
// at input row i; an odd one 2i+1 reads ky=2 at row i and ky=0 at row i+1.
// Offsets here are relative to input row i-1 (phase C's region origin), so
// they are 1, and 0 then 1.
template <int A, int C>
struct DeconvTaps {
  static constexpr int nx = C ? 2 : 1;
  static constexpr int n = (A ? 2 : 1) * nx;
  __host__ __device__ static constexpr int dy(int t) { return A ? t / nx : 1; }
  __host__ __device__ static constexpr int dx(int t) { return C ? t % nx : 1; }
};

// tanh on the special-function unit (relative error below 2^-10.9, under a
// bf16 rounding), and the sigmoid through it.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sigmoid(float x) { return fmaf(0.5f, tanh_approx(0.5f * x), 0.5f); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(const bf16* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ void store2(bf16* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&a)[2], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Asynchronous copy (cp.async) of BYTES (8 or 16) to shared memory, zeros when
// !valid (src is then not read); cp_commit(), cp_wait() and a barrier before
// reading.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 32-bit words of one GEMM's B fragments: per tap, a k8 step (G == 1, one
// word per lane) or G/2 k16 steps (two words per lane), each with NT n-tiles.
template <int G>
__host__ __device__ constexpr int frag_words(int taps, int nt) {
  return taps * (G == 1 ? 1 : G) * nt * 32;
}

// One warp's M tiles of an implicit GEMM over M rows: tile i of the warp
// starts at row 16 (warp + kWarps i), and only the first `live` of them lie in
// [0, M). Row m (clamped to M-1, whose result is dropped) is output pixel
// (m / OW, m % OW), whose base input position is (S (m / OW), S (m % OW)) in an
// input region IW pixels wide with G 8-channel slices per pixel at pitch P;
// tap t reads the pixel (dy(t), dx(t)) further. K runs over (tap, slice):
// with G == 1 one tap per m16n8k8 step (ldmatrix.x2); otherwise two slices of
// one tap per m16n8k16 step (ldmatrix.x4, lanes 16-31 addressing the second
// slice, 8 channels on), so every address offset is a constant. wf: B
// fragments in global memory (frag_words), read through L1 once per warp and
// step and used by all its tiles; A fragments are loaded a step ahead of the
// mma that use them. acc: MT x NT m16n8 accumulators, independent chains.
template <typename Taps, int G, int P, int IW, int OW, int S, int NT, int MT>
__device__ __forceinline__ void mma_tiles(const bf16* in, int M, int live,
                                          const uint32_t* __restrict__ wf, float (&acc)[MT][NT][4]) {
  constexpr int SPT = G == 1 ? 1 : G / 2;  // mma steps per tap
  constexpr int NS = Taps::n * SPT, AW = G == 1 ? 2 : 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* base[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int m = min(16 * (warp + kWarps * t) + (lane & 7) + (lane & 8), M - 1);  // ldmatrix row
    base[t] = in + ((m / OW) * S * IW + (m % OW) * S) * P + (G > 1 && lane >= 16 ? 8 : 0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][nt][i] = 0.f;
  }
  // A fragments of step s into a[s & 1], one step ahead of the mma that use them
  uint32_t a[2][MT][AW];
  auto load_a = [&](int s) {
    const int tap = s / SPT;
    const int off = (Taps::dy(tap) * IW + Taps::dx(tap)) * P + 16 * (s % SPT);
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if (t >= live) continue;
      if constexpr (G == 1)
        ldmatrix_x2(*reinterpret_cast<uint32_t(*)[2]>(a[s & 1][t]), base[t] + off);
      else
        ldmatrix_x4(*reinterpret_cast<uint32_t(*)[4]>(a[s & 1][t]), base[t] + off);
    }
  };
  load_a(0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s + 1 < NS) load_a(s + 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (G == 1) {
        const uint32_t b = __ldg(wf + (s * NT + nt) * 32 + lane);
#pragma unroll
        for (int t = 0; t < MT; ++t)
          if (t < live) mma_k8(acc[t][nt], *reinterpret_cast<uint32_t(*)[2]>(a[s & 1][t]), b);
      } else {
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(wf) + (s * NT + nt) * 32 + lane);
#pragma unroll
        for (int t = 0; t < MT; ++t)
          if (t < live) mma_k16(acc[t][nt], *reinterpret_cast<uint32_t(*)[4]>(a[s & 1][t]), b);
      }
    }
  }
}

// A whole GEMM over M rows (M a constant): each warp takes its M tiles at
// once. Its NB real output channels (the n-tiles may pad) get bias[n] (none
// when bias is null) and go to epi(m, n, v0, v1) in pairs: row m, channels n
// and n+1.
template <typename Taps, int G, int P, int IW, int OW, int S, int NT, int NB, int M, typename Epi>
__device__ __forceinline__ void gemm(const bf16* in, const uint32_t* wf, const float* bias, Epi epi) {
  constexpr int MT = cdiv(cdiv(M, 16), kWarps);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int live = (cdiv(M, 16) - warp + kWarps - 1) / kWarps;  // this warp's tiles in [0, M)
  float acc[MT][NT][4];
  mma_tiles<Taps, G, P, IW, OW, S, NT, MT>(in, M, live, wf, acc);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + (lane & 3) * 2;
    if (n >= NB) continue;
    const float2 bv = bias ? make_float2(__ldg(bias + n), __ldg(bias + n + 1)) : make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 16 * (warp + kWarps * t) + (lane >> 2) + 8 * r;
        if (m < M) epi(m, n, acc[t][nt][2 * r] + bv.x, acc[t][nt][2 * r + 1] + bv.y);
      }
  }
}

// NHWC bf16 src [H][W][C] on the RH x RW region whose origin is image pixel
// (y0, x0) -> shared pixel rows of pitch P from channel C0: CF channels per
// pixel, C of them loaded and the rest zero; zero outside the image, and
// everywhere when `zero`. Async, in 16-byte pieces where the channel counts
// allow and 8-byte ones otherwise.
template <int C, int CF, int C0, int P, int RH, int RW>
__device__ __forceinline__ void load_nhwc(bf16* dst, const bf16* src, int H, int W, int y0, int x0,
                                          bool zero) {
  constexpr int E = C % 8 == 0 && CF % 8 == 0 && C0 % 8 == 0 ? 8 : 4;  // elements per piece
  constexpr int V = CF / E;
  for (int i = threadIdx.x; i < RH * RW * V; i += kThreads) {
    const int p = i / V, v = i % V;
    const int y = y0 + p / RW, x = x0 + p % RW;
    const bool valid = v < C / E && !zero && y >= 0 && y < H && x >= 0 && x < W;
    const bf16* s = valid ? src + (static_cast<size_t>(y) * W + x) * C + E * v : src;
    cp_async<2 * E>(dst + p * P + C0 + E * v, s, valid);
  }
}

// NCHW bf16 src [cin][H][W] on the RH x RW region at image pixel (y0, x0), x0
// odd -> shared NHWC pixel rows of C channels (cin <= C) at pitch P. An item
// is two channels of two pixels (two 4-byte loads from the even column
// x0 - 1 + 2j, W even), up to nine items' loads in flight per thread; zero
// outside the image and past cin.
template <int C, int P, int RH, int RW>
__device__ __forceinline__ void load_nchw(bf16* dst, const bf16* src, int cin, int H, int W, int y0,
                                          int x0) {
  constexpr int NJ = (RW + 2) / 2, NI = RH * NJ, N = NI * (C / 2);
  constexpr int U = cdiv(N, kThreads) < 9 ? cdiv(N, kThreads) : 9;
  const size_t plane = static_cast<size_t>(H) * W;
  for (int i0 = threadIdx.x; i0 < N; i0 += U * kThreads) {
    uint32_t a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      const int q = i % NI, c = 2 * (i / NI);
      const int y = y0 + q / NJ, x = x0 - 1 + 2 * (q % NJ);
      a[u] = b[u] = 0u;
      if (i < N && c < cin && y >= 0 && y < H && x >= 0 && x < W) {
        const uint32_t* p =
            reinterpret_cast<const uint32_t*>(src + c * plane + static_cast<size_t>(y) * W + x);
        a[u] = __ldg(p);                            // channel c, pixels x and x+1
        if (c + 1 < cin) b[u] = __ldg(p + plane / 2);  // channel c+1
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= N) continue;
      const int q = i % NI, c = 2 * (i / NI);
      const int r = q / NJ, col = 2 * (q % NJ) - 1;
      if (col >= 0) store2(dst + (r * RW + col) * P + c, __byte_perm(a[u], b[u], 0x5410));
      if (col + 1 < RW) store2(dst + (r * RW + col + 1) * P + c, __byte_perm(a[u], b[u], 0x7632));
    }
  }
}

// One depth step's tensors; a phase reads the states of parity d&1 (h1, h2)
// and writes those of the other (h1n, h2n).
struct Step {
  const bf16* x;  // volume slice [B][cin][h][w]
  const bf16* h1;  // [B][h][w][b]
  const bf16* h2;  // [B][h/2][w/2][2b]
  bf16* h1n;
  bf16* h2n;
  bf16* cost;  // cost slice [B][oh][ow]
  int cin, h, w;
  int first;  // d == 0: h1 and h2 read as zero
};

struct Weights {
  const uint32_t *c1, *g1, *n1, *c2, *g2, *n2, *u1;  // B fragments; u1: its four phases in turn
  const float *bg1, *bn1, *bg2, *bn2, *bu1;       // biases, float32
  const float *wh, *bh;                           // head [(ci, ky, kx)] and its bias, float32
};

// ---- phase A: c1, GRU1 at full resolution ----

// CP: the volume's channels in shared memory (tc_width)
template <int BASE, int CP>
struct LayoutA {
  // 16x32 where shared memory still holds two blocks per SM, else 16x16
  static constexpr int TY = 16, TX = CP == 8 ? 32 : 16;
  static constexpr int C2 = 2 * BASE;  // [c1 | h1] channels
  static constexpr int XH = TY + 6, XW = TX + 6, PX = pitch(CP);
  static constexpr int GH = TY + 4, GW = TX + 4, PG = pitch(C2);
  static constexpr int NH = TY + 2, NW = TX + 2;
  static constexpr int NT1 = (BASE + 7) / 8, NTG = C2 / 8;
  static constexpr int XS = XH * XW * PX, GS = GH * GW * PG, NS = NH * NW * PG;
  static constexpr size_t bytes = (XS + GS + NS) * sizeof(bf16) + TY * TX * BASE * sizeof(float);
};

template <int BASE, int CP>
__global__ void __launch_bounds__(kThreads, 2) phase_a(Step st, Weights wt) {
  using L = LayoutA<BASE, CP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);          // x on the tile + 3
  bf16* gs = xs + L::XS;                             // [c1 | h1] on the tile + 2
  bf16* ns = gs + L::GS;                             // [c1 | r*h1] on the tile + 1
  float* us = reinterpret_cast<float*>(ns + L::NS);  // u on the tile
  const int bi = blockIdx.z, Y0 = blockIdx.y * L::TY, X0 = blockIdx.x * L::TX;
  const int h = st.h, w = st.w;
  const size_t hw = static_cast<size_t>(h) * w;

  load_nhwc<BASE, BASE, BASE, L::PG, L::GH, L::GW>(gs, st.h1 + bi * hw * BASE, h, w, Y0 - 2, X0 - 2,
                                                  st.first);
  cp_commit();
  load_nchw<CP, L::PX, L::XH, L::XW>(xs, st.x + bi * st.cin * hw, st.cin, h, w, Y0 - 3, X0 - 3);
  __syncthreads();

  // c1 = relu(conv1(x)) on the tile + 2, zero outside the image
  gemm<Conv3Taps, CP / 8, L::PX, L::XW, L::GW, 1, L::NT1, BASE, L::GH * L::GW>(
      xs, wt.c1, nullptr, [&](int m, int n, float v0, float v1) {
        const int py = m / L::GW, px = m % L::GW;
        const int y = Y0 - 2 + py, x = X0 - 2 + px;
        const bool in = y >= 0 && y < h && x >= 0 && x < w;
        const uint32_t v = in ? pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f)) : 0u;
        store2(gs + m * L::PG + n, v);
        if (py >= 1 && py <= L::NH && px >= 1 && px <= L::NW)
          store2(ns + ((py - 1) * L::NW + px - 1) * L::PG + n, v);
      });
  cp_wait<0>();  // h1
  __syncthreads();

  // gates on the tile + 1: r*h1 beside c1, u on the tile
  gemm<Conv3Taps, L::C2 / 8, L::PG, L::GW, L::NW, 1, L::NTG, 2 * BASE, L::NH * L::NW>(
      gs, wt.g1, wt.bg1, [&](int m, int n, float v0, float v1) {
        const int py = m / L::NW, px = m % L::NW;
        if (n < BASE) {
          const float2 hv = unpack2(gs + ((py + 1) * L::GW + px + 1) * L::PG + BASE + n);
          store2(ns + m * L::PG + BASE + n, pack2(sigmoid(v0) * hv.x, sigmoid(v1) * hv.y));
        } else if (py >= 1 && py <= L::TY && px >= 1 && px <= L::TX) {
          *reinterpret_cast<float2*>(us + ((py - 1) * L::TX + px - 1) * BASE + n - BASE) =
              make_float2(sigmoid(v0), sigmoid(v1));
        }
      });
  __syncthreads();

  // candidate on the tile; h1' = u h1 + (1 - u) c
  bf16* h1n = st.h1n + bi * hw * BASE;
  gemm<Conv3Taps, L::C2 / 8, L::PG, L::NW, L::TX, 1, L::NT1, BASE, L::TY * L::TX>(
      ns, wt.n1, wt.bn1, [&](int m, int n, float v0, float v1) {
        const int py = m / L::TX, px = m % L::TX;
        const int y = Y0 + py, x = X0 + px;
        if (y >= h || x >= w) return;
        const float2 hv = unpack2(gs + ((py + 2) * L::GW + px + 2) * L::PG + BASE + n);
        const float2 u = *reinterpret_cast<const float2*>(us + m * BASE + n);
        const float c0 = tanh_approx(v0), c1 = tanh_approx(v1);
        store2(h1n + (static_cast<size_t>(y) * w + x) * BASE + n,
               pack2(u.x * hv.x + (1.f - u.x) * c0, u.y * hv.y + (1.f - u.y) * c1));
      });
}

// ---- phase B: c2, GRU2 at half resolution ----

template <int BASE>
struct LayoutB {
  static constexpr int TY = 16, TX = 16;  // half-resolution tile
  static constexpr int C2 = 2 * BASE, C4 = 4 * BASE;
  static constexpr int RH = 2 * TY + 9, RW = 2 * TX + 9, P1 = pitch(8);  // h1' footprint
  static constexpr int GH = TY + 4, GW = TX + 4, PG = pitch(C4);          // [c2 | h2]
  static constexpr int NH = TY + 2, NW = TX + 2;                          // [c2 | r*h2]
  static constexpr int NTC = C2 / 8, NTG = C4 / 8;
  static constexpr int RS = RH * RW * P1, GS = GH * GW * PG, NS = NH * NW * PG;
  static constexpr size_t bytes = (RS + GS + NS) * sizeof(bf16) + TY * TX * C2 * sizeof(float);
};

template <int BASE>
__global__ void __launch_bounds__(kThreads, 2) phase_b(Step st, Weights wt) {
  using L = LayoutB<BASE>;
  constexpr int C2 = L::C2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rs = reinterpret_cast<bf16*>(smem);  // h1' on the tile's footprint
  bf16* gs = rs + L::RS;                     // [c2 | h2] on the tile + 2
  bf16* ns = gs + L::GS;                     // [c2 | r*h2] on the tile + 1
  float* us = reinterpret_cast<float*>(ns + L::NS);
  const int bi = blockIdx.z, Y0 = blockIdx.y * L::TY, X0 = blockIdx.x * L::TX;
  const int h = st.h, w = st.w, hh = h / 2, wh = w / 2;
  const size_t hw = static_cast<size_t>(h) * w, qw = static_cast<size_t>(hh) * wh;

  // half pixel Y reads full rows 2Y-1 .. 2Y+1; for Y in [Y0-2, Y0+TY+2) that is
  // rows 2Y0-5 .. 2Y0+2TY+3
  load_nhwc<BASE, 8, 0, L::P1, L::RH, L::RW>(rs, st.h1n + bi * hw * BASE, h, w, 2 * Y0 - 5,
                                            2 * X0 - 5, false);
  cp_commit();
  load_nhwc<C2, C2, C2, L::PG, L::GH, L::GW>(gs, st.h2 + bi * qw * C2, hh, wh, Y0 - 2, X0 - 2,
                                            st.first);
  cp_commit();
  cp_wait<1>();  // h1'
  __syncthreads();

  // c2 = relu(conv2 stride 2(h1')) on the tile + 2, zero outside the half image
  gemm<Conv3Taps, 1, L::P1, L::RW, L::GW, 2, L::NTC, C2, L::GH * L::GW>(
      rs, wt.c2, nullptr, [&](int m, int n, float v0, float v1) {
        const int py = m / L::GW, px = m % L::GW;
        const int y = Y0 - 2 + py, x = X0 - 2 + px;
        const bool in = y >= 0 && y < hh && x >= 0 && x < wh;
        const uint32_t v = in ? pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f)) : 0u;
        store2(gs + m * L::PG + n, v);
        if (py >= 1 && py <= L::NH && px >= 1 && px <= L::NW)
          store2(ns + ((py - 1) * L::NW + px - 1) * L::PG + n, v);
      });
  cp_wait<0>();  // h2
  __syncthreads();

  gemm<Conv3Taps, L::C4 / 8, L::PG, L::GW, L::NW, 1, L::NTG, L::C4, L::NH * L::NW>(
      gs, wt.g2, wt.bg2, [&](int m, int n, float v0, float v1) {
        const int py = m / L::NW, px = m % L::NW;
        if (n < C2) {
          const float2 hv = unpack2(gs + ((py + 1) * L::GW + px + 1) * L::PG + C2 + n);
          store2(ns + m * L::PG + C2 + n, pack2(sigmoid(v0) * hv.x, sigmoid(v1) * hv.y));
        } else if (py >= 1 && py <= L::TY && px >= 1 && px <= L::TX) {
          *reinterpret_cast<float2*>(us + ((py - 1) * L::TX + px - 1) * C2 + n - C2) =
              make_float2(sigmoid(v0), sigmoid(v1));
        }
      });
  __syncthreads();

  bf16* h2n = st.h2n + bi * qw * C2;
  gemm<Conv3Taps, L::C4 / 8, L::PG, L::NW, L::TX, 1, L::NTC, C2, L::TY * L::TX>(
      ns, wt.n2, wt.bn2, [&](int m, int n, float v0, float v1) {
        const int py = m / L::TX, px = m % L::TX;
        const int y = Y0 + py, x = X0 + px;
        if (y >= hh || x >= wh) return;
        const float2 hv = unpack2(gs + ((py + 2) * L::GW + px + 2) * L::PG + C2 + n);
        const float2 u = *reinterpret_cast<const float2*>(us + m * C2 + n);
        const float c0 = tanh_approx(v0), c1 = tanh_approx(v1);
        store2(h2n + (static_cast<size_t>(y) * wh + x) * C2 + n,
               pack2(u.x * hv.x + (1.f - u.x) * c0, u.y * hv.y + (1.f - u.y) * c1));
      });
}

// ---- phase C: u1 and the head ----

template <int BASE, int UP>
struct LayoutC {
  // even, so the half origin is whole; the 2x head's outputs favour the shorter tile
  static constexpr int TY = UP ? 16 : 32, TX = 32;
  static constexpr int C2 = 2 * BASE, G = C2 / 8;
  static constexpr int UH = TY + 2, UW = TX + 2, PU = 8;                  // u1, h1' on the tile + 1
  static constexpr int QH = TY / 2 + 2, QW = TX / 2 + 2, PQ = pitch(C2);  // h2'
  static constexpr int SH = TY / 2 + 1, SW = TX / 2 + 1;  // pixels of one output phase
  // fragment words of the four output phases' GEMMs, which follow each other
  static constexpr int F00 = frag_words<G>(1, 1), F01 = frag_words<G>(2, 1);
  static constexpr int F10 = frag_words<G>(2, 1);
  static constexpr int US = UH * UW * PU, QS = QH * QW * PQ;
  static constexpr size_t bytes = (2 * US + QS) * sizeof(bf16) + 9 * BASE * sizeof(float);
};

// u1 = relu(deconv(h2') + b + h1') at the region pixels of output phase (A, C)
template <int BASE, int UP, int A, int C>
__device__ __forceinline__ void u1_phase(const bf16* qs, const bf16* hs, bf16* us, const uint32_t* wf,
                                         const float* bias, int Y0, int X0, int h, int w) {
  using L = LayoutC<BASE, UP>;
  gemm<DeconvTaps<A, C>, L::G, L::PQ, L::QW, L::SW, 1, 1, BASE, L::SH * L::SW>(
      qs, wf, bias, [&](int m, int n, float v0, float v1) {
        const int py = 2 * (m / L::SW) + 1 - A, px = 2 * (m % L::SW) + 1 - C;
        const int y = Y0 - 1 + py, x = X0 - 1 + px;
        const int o = (py * L::UW + px) * L::PU + n;
        uint32_t v = 0u;
        if (y >= 0 && y < h && x >= 0 && x < w) {
          const float2 sk = unpack2(hs + o);
          v = pack2(fmaxf(v0 + sk.x, 0.f), fmaxf(v1 + sk.y, 0.f));
        }
        store2(us + o, v);
      });
}

template <int BASE, int UP>
__global__ void __launch_bounds__(kThreads, 2) phase_c(Step st, Weights wt) {
  using L = LayoutC<BASE, UP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);  // h1' on the tile + 1
  bf16* us = hs + L::US;                     // u1 on the tile + 1
  bf16* qs = us + L::US;                     // h2' around the tile
  float* whs = reinterpret_cast<float*>(qs + L::QS);
  const int bi = blockIdx.z, Y0 = blockIdx.y * L::TY, X0 = blockIdx.x * L::TX;
  const int h = st.h, w = st.w, hh = h / 2, wh = w / 2;
  const size_t hw = static_cast<size_t>(h) * w, qw = static_cast<size_t>(hh) * wh;

  for (int i = threadIdx.x; i < 9 * BASE / 4; i += kThreads) cp_async<16>(whs + 4 * i, wt.wh + 4 * i, true);
  load_nhwc<L::C2, L::C2, 0, L::PQ, L::QH, L::QW>(qs, st.h2n + bi * qw * L::C2, hh, wh, Y0 / 2 - 1,
                                                  X0 / 2 - 1, false);
  load_nhwc<BASE, BASE, 0, L::PU, L::UH, L::UW>(hs, st.h1n + bi * hw * BASE, h, w, Y0 - 1, X0 - 1,
                                                false);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  u1_phase<BASE, UP, 0, 0>(qs, hs, us, wt.u1, wt.bu1, Y0, X0, h, w);
  u1_phase<BASE, UP, 0, 1>(qs, hs, us, wt.u1 + L::F00, wt.bu1, Y0, X0, h, w);
  u1_phase<BASE, UP, 1, 0>(qs, hs, us, wt.u1 + L::F00 + L::F01, wt.bu1, Y0, X0, h, w);
  u1_phase<BASE, UP, 1, 1>(qs, hs, us, wt.u1 + L::F00 + L::F01 + L::F10, wt.bu1, Y0, X0, h, w);
  __syncthreads();

  // the head on the CUDA cores; whs[(ci * 3 + ky) * 3 + kx], u1 at region (py + 1, px + 1)
  const float bh = __ldg(wt.bh);
  auto u1_at = [&](int py, int px, float (&v)[8]) {  // u1's channels at region pixel (py, px)
    const uint4 q = *reinterpret_cast<const uint4*>(us + (py * L::UW + px) * L::PU);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(words[j] << 16);
      v[2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  };
  auto dot = [&](const float (&v)[8], int ky, int kx, float s) {
#pragma unroll
    for (int n = 0; n < BASE; ++n) s = fmaf(v[n], whs[(n * 3 + ky) * 3 + kx], s);
    return s;
  };
  for (int i = threadIdx.x; i < L::TY * L::TX; i += kThreads) {
    const int py = i / L::TX, px = i % L::TX;
    const int y = Y0 + py, x = X0 + px;
    if (y >= h || x >= w) continue;
    float v[8];
    if constexpr (UP) {
      // the 2x2 outputs (2y + a, 2x + c): an even output row reads ky=1 at row y, an odd one
      // ky=2 at y and ky=0 at y+1 (oy = 2 iy - 1 + ky); columns alike
      float o00 = bh, o01 = bh, o10 = bh, o11 = bh;
      u1_at(py + 1, px + 1, v);
      o00 = dot(v, 1, 1, o00), o01 = dot(v, 1, 2, o01), o10 = dot(v, 2, 1, o10), o11 = dot(v, 2, 2, o11);
      u1_at(py + 1, px + 2, v);
      o01 = dot(v, 1, 0, o01), o11 = dot(v, 2, 0, o11);
      u1_at(py + 2, px + 1, v);
      o10 = dot(v, 0, 1, o10), o11 = dot(v, 0, 2, o11);
      u1_at(py + 2, px + 2, v);
      o11 = dot(v, 0, 0, o11);
      bf16* out = st.cost + static_cast<size_t>(bi) * 4 * hw + (2 * static_cast<size_t>(y)) * 2 * w + 2 * x;
      store2(out, pack2(o00, o01));
      store2(out + 2 * w, pack2(o10, o11));
    } else {
      float o = bh;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          u1_at(py + ky, px + kx, v);
          o = dot(v, ky, kx, o);
        }
      st.cost[bi * hw + static_cast<size_t>(y) * w + x] = __float2bfloat16_rn(o);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int BASE, int CP, int UP>
int run(int cin, int D, int B, int h, int w, const bf16* vol, const Weights& wt, bf16* cost,
        bf16* scratch, cudaStream_t s) {
  using LA = LayoutA<BASE, CP>;
  using LB = LayoutB<BASE>;
  using LC = LayoutC<BASE, UP>;
  cudaError_t e;
  if ((e = allow_smem(phase_a<BASE, CP>, LA::bytes)) != cudaSuccess) return static_cast<int>(e);
  if ((e = allow_smem(phase_b<BASE>, LB::bytes)) != cudaSuccess) return static_cast<int>(e);
  if ((e = allow_smem(phase_c<BASE, UP>, LC::bytes)) != cudaSuccess) return static_cast<int>(e);
  const int hh = h / 2, wh = w / 2;
  const size_t n1 = static_cast<size_t>(B) * h * w * BASE;
  const size_t n2 = static_cast<size_t>(B) * hh * wh * 2 * BASE;
  bf16* h1[2] = {scratch, scratch + n1};
  bf16* h2[2] = {scratch + 2 * n1, scratch + 2 * n1 + n2};
  const dim3 ga(cdiv(w, LA::TX), cdiv(h, LA::TY), B);
  const dim3 gb(cdiv(wh, LB::TX), cdiv(hh, LB::TY), B);
  const dim3 gc(cdiv(w, LC::TX), cdiv(h, LC::TY), B);
  const size_t out = static_cast<size_t>(B) * h * w * (UP ? 4 : 1);
  for (int d = 0; d < D; ++d) {
    const int p = d & 1;
    const Step st{vol + static_cast<size_t>(d) * B * cin * h * w, h1[p], h2[p], h1[1 - p], h2[1 - p],
                  cost + d * out, cin, h, w, d == 0};
    phase_a<BASE, CP><<<ga, kThreads, LA::bytes, s>>>(st, wt);
    phase_b<BASE><<<gb, kThreads, LB::bytes, s>>>(st, wt);
    phase_c<BASE, UP><<<gc, kThreads, LC::bytes, s>>>(st, wt);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int BASE, int CP>
int run_up(int cin, int up, int D, int B, int h, int w, const bf16* vol, const Weights& wt,
           bf16* cost, bf16* scratch, cudaStream_t s) {
  return up ? run<BASE, CP, 1>(cin, D, B, h, w, vol, wt, cost, scratch, s)
            : run<BASE, CP, 0>(cin, D, B, h, w, vol, wt, cost, scratch, s);
}

template <int BASE>
int run_cin(int cin, int up, int D, int B, int h, int w, const bf16* vol, const Weights& wt,
            bf16* cost, bf16* scratch, cudaStream_t s) {
  if (cin < 1) return adamvs::kBadChannels;
  if (cin <= 8) return run_up<BASE, 8>(cin, up, D, B, h, w, vol, wt, cost, scratch, s);
  if (cin <= 16) return run_up<BASE, 16>(cin, up, D, B, h, w, vol, wt, cost, scratch, s);
  if (cin <= 32) return run_up<BASE, 32>(cin, up, D, B, h, w, vol, wt, cost, scratch, s);
  if (cin <= 64) return run_up<BASE, 64>(cin, up, D, B, h, w, vol, wt, cost, scratch, s);
  return adamvs::kBadChannels;
}

}  // namespace tc

// ------------------------------------------- float32, split TF32 (3xTF32) --

namespace f32 {

using tc::cdiv;
using tc::Conv3Taps;
using tc::cp_async;
using tc::cp_commit;
using tc::cp_wait;
using tc::DeconvTaps;
using tc::pitch;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// pixel pitch (floats) of the stride-2 convolution's input, 8 channels: output
// pixels 1 apart read input pixels 24 floats apart, so 4 of them fall in
// distinct 8-bank groups
constexpr int kPitchS2 = 12;

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): a float32 bit pattern whose low 13 mantissa bits are zero. Two
// integer operations; cvt.rna compiles to four on sm_90 (a range test and a
// select besides), and the split is most of the ALU work of the GEMMs.
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x as an mma operand rounded to TF32: the tensor cores read the top 19 bits
// of a .tf32 operand and ignore the low 13, so adding half of the dropped
// unit is the whole of the rounding (the same value as tf32(x)).
__device__ __forceinline__ uint32_t tf32_operand(float x) { return __float_as_uint(x) + 0x1000u; }

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// One warp's M tiles of an implicit GEMM over M rows, float32 operands as
// three TF32 products: a_hi b_lo + a_lo b_hi + a_hi b_hi, float32 sums
// (x = hi + lo, each rounded to TF32; a_lo b_lo, ~2^-22 of the product, is
// left out). Tile i of the warp starts at row 16 (warp + kWarps (T0 + i));
// the warp runs all MT of them, or none without `run`. Row m (clamped to
// M-1, whose result is dropped) is output pixel (m / OW, m % OW), whose base
// input position is (S (m / OW), S (m % OW)) in an input region IW pixels
// wide with G 8-channel slices per pixel at pitch P; tap t reads the pixel
// (dy(t), dx(t)) further.
// K runs over (tap, slice), one m16n8k8 step each. Within a slice the k order
// is permuted: k = q holds channel 2q and k = q + 4 channel 2q + 1, so a lane
// loads its A elements of one row as one float2 and the packed B fragments
// are the k8 layout of ops/red_scan.py::mma_fragments. wf: per (step, n-tile,
// lane) the B fragment's words (b0_hi, b1_hi, b0_lo, b1_lo), read through L1
// once per warp and step and used by all its tiles. A is loaded a step ahead
// of the mma that use it and split as it leaves shared memory: hi needs its
// low bits cleared, since lo = x - hi, but lo goes to the mma as
// tf32_operand.
template <typename Taps, int G, int P, int IW, int OW, int S, int NT, int MT, int T0>
__device__ __forceinline__ void mma_tiles(const float* in, int M, bool run,
                                          const uint4* __restrict__ wf, float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base[MT][2];  // the lane's rows m and m + 8 at tap (0, 0), channel 2q
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = min(16 * (warp + kWarps * (T0 + t)) + (lane >> 2) + 8 * r, M - 1);
      base[t][r] = ((m / OW) * S * IW + (m % OW) * S) * P + 2 * (lane & 3);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][nt][i] = 0.f;
  }
  if (!run) return;
  auto load_a = [&](float2 (&dst)[MT][2], int off) {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int r = 0; r < 2; ++r) dst[t][r] = load2(in + base[t][r] + off);
    }
  };
  auto tap_off = [](int tap) { return (Taps::dy(tap) * IW + Taps::dx(tap)) * P; };
  float2 nxt[MT][2];
  load_a(nxt, tap_off(0));
  const uint4* w = wf + lane;
#pragma unroll
  for (int tap = 0; tap < Taps::n; ++tap) {
    const int off = tap_off(tap);
    const int off_next = tap + 1 < Taps::n ? tap_off(tap + 1) : off;
#pragma unroll
    for (int g = 0; g < G; ++g, w += NT * 32) {
      float2 cur[MT][2];
#pragma unroll
      for (int t = 0; t < MT; ++t) cur[t][0] = nxt[t][0], cur[t][1] = nxt[t][1];
      if (g + 1 < G)
        load_a(nxt, off + 8 * (g + 1));
      else if (tap + 1 < Taps::n)
        load_a(nxt, off_next);
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        // a0 (row m, k q), a1 (row m + 8, k q), a2 (row m, k q + 4), a3 (row m + 8, k q + 4)
        const float v[4] = {cur[t][0].x, cur[t][1].x, cur[t][0].y, cur[t][1].y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[t][i] = tf32(v[i]);
          lo[t][i] = tf32_operand(v[i] - __uint_as_float(hi[t][i]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = __ldg(w + nt * 32);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma_tf32(acc[t][nt], hi[t], b.z, b.w);
          mma_tf32(acc[t][nt], lo[t], b.x, b.y);
          mma_tf32(acc[t][nt], hi[t], b.x, b.y);
        }
      }
    }
  }
}

// Tiles T0 .. T0 + MT - 1 of every warp of a GEMM over M rows (see gemm),
// through their epilogue; with `run` false the warp does nothing.
template <typename Taps, int G, int P, int IW, int OW, int S, int NT, int NB, int M, int MT, int T0,
          typename Epi>
__device__ __forceinline__ void gemm_pass(const float* in, const uint4* wf, const float* bias, bool run,
                                          Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[MT][NT][4];
  mma_tiles<Taps, G, P, IW, OW, S, NT, MT, T0>(in, M, run, wf, acc);
  if (!run) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + (lane & 3) * 2;
    if (n >= NB) continue;
    const float2 bv = bias ? make_float2(__ldg(bias + n), __ldg(bias + n + 1)) : make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 16 * (warp + kWarps * (T0 + t)) + (lane >> 2) + 8 * r;
        if (m < M) epi(m, n, acc[t][nt][2 * r] + bv.x, acc[t][nt][2 * r + 1] + bv.y);
      }
  }
}

// A whole GEMM over M rows (M a constant). Its NB real output channels (the
// n-tiles may pad) get bias[n] (none when bias is null) and go to epi(m, n,
// v0, v1) in pairs: row m, channels n and n+1. The M tiles go to the warps
// in two passes: first every warp takes FULL tiles at once, then the REM
// tiles left take one warp each while the other warps skip the pass. A
// warp's tiles within a pass all run: a test of each tile against M around
// the mma would make the compiler fence every mma with a warp barrier.
template <typename Taps, int G, int P, int IW, int OW, int S, int NT, int NB, int M, typename Epi>
__device__ __forceinline__ void gemm(const float* in, const uint4* wf, const float* bias, Epi epi) {
  constexpr int TILES = cdiv(M, 16), FULL = TILES / kWarps, REM = TILES % kWarps;
  if constexpr (FULL > 0)
    gemm_pass<Taps, G, P, IW, OW, S, NT, NB, M, FULL, 0>(in, wf, bias, true, epi);
  if constexpr (REM > 0)
    gemm_pass<Taps, G, P, IW, OW, S, NT, NB, M, 1, FULL>(in, wf, bias, (threadIdx.x >> 5) < REM, epi);
}

// NHWC float32 src [H][W][C] on the RH x RW region whose origin is image pixel
// (y0, x0) -> shared pixel rows of pitch P from channel C0: CF channels per
// pixel, C of them loaded and the rest zero; zero outside the image, and
// everywhere when `zero`. Async, in 16-byte pieces.
template <int C, int CF, int C0, int P, int RH, int RW>
__device__ __forceinline__ void load_nhwc(float* dst, const float* src, int H, int W, int y0, int x0,
                                          bool zero) {
  static_assert(C % 4 == 0 && CF % 4 == 0 && C0 % 4 == 0 && P % 4 == 0, "16-byte pieces");
  constexpr int V = CF / 4;
  for (int i = threadIdx.x; i < RH * RW * V; i += kThreads) {
    const int p = i / V, v = i % V;
    const int y = y0 + p / RW, x = x0 + p % RW;
    const bool valid = v < C / 4 && !zero && y >= 0 && y < H && x >= 0 && x < W;
    const float* s = valid ? src + (static_cast<size_t>(y) * W + x) * C + 4 * v : src;
    cp_async<16>(dst + p * P + C0 + 4 * v, s, valid);
  }
}

// NCHW float32 src [cin][H][W] on the RH x RW region at image pixel (y0, x0)
// -> shared NHWC pixel rows of CP channels (cin <= CP) at pitch P, zero
// outside the image and past cin. An item is 4 channels of one pixel,
// neighbouring threads on neighbouring pixels: 4 loads and one 16-byte store,
// 4 items' loads in flight per thread.
template <int CP, int P, int RH, int RW>
__device__ __forceinline__ void load_nchw(float* dst, const float* src, int cin, int H, int W, int y0,
                                          int x0) {
  constexpr int NP = RH * RW, N = NP * (CP / 4), U = 4;
  const size_t plane = static_cast<size_t>(H) * W;
  for (int i0 = threadIdx.x; i0 < N; i0 += U * kThreads) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      const int p = i % NP, c = 4 * (i / NP);
      const int y = y0 + p / RW, x = x0 + p % RW;
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < N && y >= 0 && y < H && x >= 0 && x < W) {
        const float* s = src + static_cast<size_t>(y) * W + x;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < cin) e[j] = __ldg(s + (c + j) * plane);
      }
      v[u] = make_float4(e[0], e[1], e[2], e[3]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i < N) *reinterpret_cast<float4*>(dst + (i % NP) * P + 4 * (i / NP)) = v[u];
    }
  }
}

// One depth step's tensors; a phase reads the states of parity d&1 (h1, h2)
// and writes those of the other (h1n, h2n).
struct Step {
  const float* x;  // volume slice [B][cin][h][w]
  const float* h1;  // [B][h][w][b]
  const float* h2;  // [B][h/2][w/2][2b]
  float* h1n;
  float* h2n;
  float* cost;  // cost slice [B][oh][ow]
  int cin, h, w;
  int first;  // d == 0: h1 and h2 read as zero
};

struct Weights {
  const uint4 *c1, *g1, *n1, *c2, *g2, *n2, *u1;  // split B fragments; u1: its four phases in turn
  const float *bg1, *bn1, *bg2, *bn2, *bu1;     // biases
  const float *wh, *bh;                         // head [(ci, ky, kx)] and its bias
};

// ---- phase A: c1, GRU1 at full resolution ----

// CP: the volume's channels in shared memory (tc_width). The x window is
// dead once c1 is computed, so [c1 | r*h1] on the tile + 1 and u on the tile
// take its place.
template <int BASE, int CP>
struct LayoutA {
  static constexpr int TY = CP <= 16 ? 16 : 8, TX = 16;
  static constexpr int C2 = 2 * BASE;  // [c1 | h1] channels
  static constexpr int XH = TY + 6, XW = TX + 6, PX = pitch(CP);
  static constexpr int GH = TY + 4, GW = TX + 4, PG = pitch(C2);
  static constexpr int NH = TY + 2, NW = TX + 2;
  static constexpr int NTG = C2 / 8;
  static constexpr int XS = XH * XW * PX, GS = GH * GW * PG, NS = NH * NW * PG, US = TY * TX * BASE;
  static constexpr size_t bytes = ((XS > NS + US ? XS : NS + US) + GS) * sizeof(float);
};

template <int BASE, int CP>
__global__ void __launch_bounds__(kThreads, 2) phase_a(Step st, Weights wt) {
  using L = LayoutA<BASE, CP>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);  // [c1 | h1] on the tile + 2
  float* xs = gs + L::GS;                      // x on the tile + 3
  float* ns = xs;                              // then [c1 | r*h1] on the tile + 1
  float* us = ns + L::NS;                      // and u on the tile
  const int bi = blockIdx.z, Y0 = blockIdx.y * L::TY, X0 = blockIdx.x * L::TX;
  const int h = st.h, w = st.w;
  const size_t hw = static_cast<size_t>(h) * w;

  load_nhwc<BASE, BASE, BASE, L::PG, L::GH, L::GW>(gs, st.h1 + bi * hw * BASE, h, w, Y0 - 2, X0 - 2,
                                                  st.first);
  cp_commit();
  load_nchw<CP, L::PX, L::XH, L::XW>(xs, st.x + bi * st.cin * hw, st.cin, h, w, Y0 - 3, X0 - 3);
  __syncthreads();

  // c1 = relu(conv1(x)) on the tile + 2, zero outside the image
  gemm<Conv3Taps, CP / 8, L::PX, L::XW, L::GW, 1, 1, BASE, L::GH * L::GW>(
      xs, wt.c1, nullptr, [&](int m, int n, float v0, float v1) {
        const int y = Y0 - 2 + m / L::GW, x = X0 - 2 + m % L::GW;
        const bool in = y >= 0 && y < h && x >= 0 && x < w;
        store2(gs + m * L::PG + n, in ? fmaxf(v0, 0.f) : 0.f, in ? fmaxf(v1, 0.f) : 0.f);
      });
  cp_wait<0>();  // h1
  __syncthreads();

  // gates on the tile + 1: c1 and r*h1 to ns, u on the tile
  gemm<Conv3Taps, L::C2 / 8, L::PG, L::GW, L::NW, 1, L::NTG, 2 * BASE, L::NH * L::NW>(
      gs, wt.g1, wt.bg1, [&](int m, int n, float v0, float v1) {
        const int py = m / L::NW, px = m % L::NW;
        const float* g = gs + ((py + 1) * L::GW + px + 1) * L::PG;
        if (n < BASE) {
          const float2 c = load2(g + n), hv = load2(g + BASE + n);
          store2(ns + m * L::PG + n, c.x, c.y);
          store2(ns + m * L::PG + BASE + n, sigmoid(v0) * hv.x, sigmoid(v1) * hv.y);
        } else if (py >= 1 && py <= L::TY && px >= 1 && px <= L::TX) {
          store2(us + ((py - 1) * L::TX + px - 1) * BASE + n - BASE, sigmoid(v0), sigmoid(v1));
        }
      });
  __syncthreads();

  // candidate on the tile; h1' = u h1 + (1 - u) c
  float* h1n = st.h1n + bi * hw * BASE;
  gemm<Conv3Taps, L::C2 / 8, L::PG, L::NW, L::TX, 1, 1, BASE, L::TY * L::TX>(
      ns, wt.n1, wt.bn1, [&](int m, int n, float v0, float v1) {
        const int py = m / L::TX, px = m % L::TX;
        const int y = Y0 + py, x = X0 + px;
        if (y >= h || x >= w) return;
        const float2 hv = load2(gs + ((py + 2) * L::GW + px + 2) * L::PG + BASE + n);
        const float2 u = load2(us + m * BASE + n);
        const float c0 = tanhf(v0), c1 = tanhf(v1);
        store2(h1n + (static_cast<size_t>(y) * w + x) * BASE + n, u.x * hv.x + (1.f - u.x) * c0,
               u.y * hv.y + (1.f - u.y) * c1);
      });
}

// ---- phase B: c2, GRU2 at half resolution ----

// TY x TX half-resolution tiles; the h1' footprint is dead once c2 is
// computed, so [c2 | r*h2] and u take its place
template <int BASE, int TY_, int TX_>
struct LayoutB {
  static constexpr int TY = TY_, TX = TX_;
  static constexpr int C2 = 2 * BASE, C4 = 4 * BASE;
  static constexpr int RH = 2 * TY + 9, RW = 2 * TX + 9, P1 = kPitchS2;  // h1' footprint
  static constexpr int GH = TY + 4, GW = TX + 4, PG = pitch(C4);         // [c2 | h2]
  static constexpr int NH = TY + 2, NW = TX + 2;                         // [c2 | r*h2]
  static constexpr int NTC = C2 / 8, NTG = C4 / 8;
  static constexpr int RS = RH * RW * P1, GS = GH * GW * PG, NS = NH * NW * PG, US = TY * TX * C2;
  static constexpr size_t bytes = ((RS > NS + US ? RS : NS + US) + GS) * sizeof(float);
};

template <int BASE, int TY, int TX>
__global__ void __launch_bounds__(kThreads, 2) phase_b(Step st, Weights wt) {
  using L = LayoutB<BASE, TY, TX>;
  constexpr int C2 = L::C2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);  // [c2 | h2] on the tile + 2
  float* rs = gs + L::GS;                      // h1' on the tile's footprint
  float* ns = rs;                              // then [c2 | r*h2] on the tile + 1
  float* us = ns + L::NS;                      // and u on the tile
  const int bi = blockIdx.z, Y0 = blockIdx.y * TY, X0 = blockIdx.x * TX;
  const int h = st.h, w = st.w, hh = h / 2, wh = w / 2;
  const size_t hw = static_cast<size_t>(h) * w, qw = static_cast<size_t>(hh) * wh;

  // half pixel Y reads full rows 2Y-1 .. 2Y+1; for Y in [Y0-2, Y0+TY+2) that is
  // rows 2Y0-5 .. 2Y0+2TY+3
  load_nhwc<BASE, 8, 0, L::P1, L::RH, L::RW>(rs, st.h1n + bi * hw * BASE, h, w, 2 * Y0 - 5,
                                            2 * X0 - 5, false);
  cp_commit();
  load_nhwc<C2, C2, C2, L::PG, L::GH, L::GW>(gs, st.h2 + bi * qw * C2, hh, wh, Y0 - 2, X0 - 2,
                                            st.first);
  cp_commit();
  cp_wait<1>();  // h1'
  __syncthreads();

  // c2 = relu(conv2 stride 2(h1')) on the tile + 2, zero outside the half image
  gemm<Conv3Taps, 1, L::P1, L::RW, L::GW, 2, L::NTC, C2, L::GH * L::GW>(
      rs, wt.c2, nullptr, [&](int m, int n, float v0, float v1) {
        const int y = Y0 - 2 + m / L::GW, x = X0 - 2 + m % L::GW;
        const bool in = y >= 0 && y < hh && x >= 0 && x < wh;
        store2(gs + m * L::PG + n, in ? fmaxf(v0, 0.f) : 0.f, in ? fmaxf(v1, 0.f) : 0.f);
      });
  cp_wait<0>();  // h2
  __syncthreads();

  // gates on the tile + 1: c2 and r*h2 to ns, u on the tile
  gemm<Conv3Taps, L::C4 / 8, L::PG, L::GW, L::NW, 1, L::NTG, L::C4, L::NH * L::NW>(
      gs, wt.g2, wt.bg2, [&](int m, int n, float v0, float v1) {
        const int py = m / L::NW, px = m % L::NW;
        const float* g = gs + ((py + 1) * L::GW + px + 1) * L::PG;
        if (n < C2) {
          const float2 c = load2(g + n), hv = load2(g + C2 + n);
          store2(ns + m * L::PG + n, c.x, c.y);
          store2(ns + m * L::PG + C2 + n, sigmoid(v0) * hv.x, sigmoid(v1) * hv.y);
        } else if (py >= 1 && py <= TY && px >= 1 && px <= TX) {
          store2(us + ((py - 1) * TX + px - 1) * C2 + n - C2, sigmoid(v0), sigmoid(v1));
        }
      });
  __syncthreads();

  float* h2n = st.h2n + bi * qw * C2;
  gemm<Conv3Taps, L::C4 / 8, L::PG, L::NW, TX, 1, L::NTC, C2, TY * TX>(
      ns, wt.n2, wt.bn2, [&](int m, int n, float v0, float v1) {
        const int py = m / TX, px = m % TX;
        const int y = Y0 + py, x = X0 + px;
        if (y >= hh || x >= wh) return;
        const float2 hv = load2(gs + ((py + 2) * L::GW + px + 2) * L::PG + C2 + n);
        const float2 u = load2(us + m * C2 + n);
        const float c0 = tanhf(v0), c1 = tanhf(v1);
        store2(h2n + (static_cast<size_t>(y) * wh + x) * C2 + n, u.x * hv.x + (1.f - u.x) * c0,
               u.y * hv.y + (1.f - u.y) * c1);
      });
}

// ---- phase C: u1 and the head ----

// TY x TX full-resolution tiles, both even (so the half origin is whole)
template <int BASE, int TY_, int TX_>
struct LayoutC {
  static constexpr int TY = TY_, TX = TX_;
  static constexpr int C2 = 2 * BASE, G = C2 / 8;
  static constexpr int UH = TY + 2, UW = TX + 2, PU = 8;                  // u1, h1' on the tile + 1
  static constexpr int QH = TY / 2 + 2, QW = TX / 2 + 2, PQ = pitch(C2);  // h2'
  static constexpr int SH = TY / 2 + 1, SW = TX / 2 + 1;  // pixels of one output phase
  // fragment entries of the output phases (0, 0), (0, 1), (1, 0): 1, 2, 2 taps
  static constexpr int F00 = 1 * G * 32, F01 = 2 * G * 32, F10 = 2 * G * 32;
  static constexpr int US = UH * UW * PU, QS = QH * QW * PQ;
  static constexpr size_t bytes = (2 * US + QS + 9 * BASE) * sizeof(float);
};

// u1 = relu(deconv(h2') + b + h1') at the region pixels of output phase (A, C)
template <typename L, int BASE, int A, int C>
__device__ __forceinline__ void u1_phase(const float* qs, const float* hs, float* us, const uint4* wf,
                                         const float* bias, int Y0, int X0, int h, int w) {
  gemm<DeconvTaps<A, C>, L::G, L::PQ, L::QW, L::SW, 1, 1, BASE, L::SH * L::SW>(
      qs, wf, bias, [&](int m, int n, float v0, float v1) {
        const int py = 2 * (m / L::SW) + 1 - A, px = 2 * (m % L::SW) + 1 - C;
        const int y = Y0 - 1 + py, x = X0 - 1 + px;
        const int o = (py * L::UW + px) * L::PU + n;
        float2 v = make_float2(0.f, 0.f);
        if (y >= 0 && y < h && x >= 0 && x < w) {
          const float2 sk = load2(hs + o);
          v = make_float2(fmaxf(v0 + sk.x, 0.f), fmaxf(v1 + sk.y, 0.f));
        }
        store2(us + o, v.x, v.y);
      });
}

template <int BASE, int UP, int TY, int TX>
__global__ void __launch_bounds__(kThreads, 2) phase_c(Step st, Weights wt) {
  using L = LayoutC<BASE, TY, TX>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);  // h1' on the tile + 1
  float* us = hs + L::US;                      // u1 on the tile + 1
  float* qs = us + L::US;                      // h2' around the tile
  float* whs = qs + L::QS;
  const int bi = blockIdx.z, Y0 = blockIdx.y * TY, X0 = blockIdx.x * TX;
  const int h = st.h, w = st.w, hh = h / 2, wh = w / 2;
  const size_t hw = static_cast<size_t>(h) * w, qw = static_cast<size_t>(hh) * wh;

  for (int i = threadIdx.x; i < 9 * BASE / 4; i += kThreads) cp_async<16>(whs + 4 * i, wt.wh + 4 * i, true);
  load_nhwc<L::C2, L::C2, 0, L::PQ, L::QH, L::QW>(qs, st.h2n + bi * qw * L::C2, hh, wh, Y0 / 2 - 1,
                                                  X0 / 2 - 1, false);
  load_nhwc<BASE, BASE, 0, L::PU, L::UH, L::UW>(hs, st.h1n + bi * hw * BASE, h, w, Y0 - 1, X0 - 1,
                                                false);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  u1_phase<L, BASE, 0, 0>(qs, hs, us, wt.u1, wt.bu1, Y0, X0, h, w);
  u1_phase<L, BASE, 0, 1>(qs, hs, us, wt.u1 + L::F00, wt.bu1, Y0, X0, h, w);
  u1_phase<L, BASE, 1, 0>(qs, hs, us, wt.u1 + L::F00 + L::F01, wt.bu1, Y0, X0, h, w);
  u1_phase<L, BASE, 1, 1>(qs, hs, us, wt.u1 + L::F00 + L::F01 + L::F10, wt.bu1, Y0, X0, h, w);
  __syncthreads();

  // the head on the CUDA cores in float32; whs[(ci * 3 + ky) * 3 + kx], u1 at region (py + 1, px + 1)
  const float bh = __ldg(wt.bh);
  auto u1_at = [&](int py, int px, float (&v)[BASE]) {  // u1's channels at region pixel (py, px)
#pragma unroll
    for (int j = 0; j < BASE / 4; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(us + (py * L::UW + px) * L::PU + 4 * j);
      v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
    }
  };
  auto dot = [&](const float (&v)[BASE], int ky, int kx, float s) {
#pragma unroll
    for (int n = 0; n < BASE; ++n) s = fmaf(v[n], whs[(n * 3 + ky) * 3 + kx], s);
    return s;
  };
  for (int i = threadIdx.x; i < TY * TX; i += kThreads) {
    const int py = i / TX, px = i % TX;
    const int y = Y0 + py, x = X0 + px;
    if (y >= h || x >= w) continue;
    float v[BASE];
    if constexpr (UP) {
      // the 2x2 outputs (2y + a, 2x + c): an even output row reads ky=1 at row y, an odd one
      // ky=2 at y and ky=0 at y+1 (oy = 2 iy - 1 + ky); columns alike
      float o00 = bh, o01 = bh, o10 = bh, o11 = bh;
      u1_at(py + 1, px + 1, v);
      o00 = dot(v, 1, 1, o00), o01 = dot(v, 1, 2, o01), o10 = dot(v, 2, 1, o10), o11 = dot(v, 2, 2, o11);
      u1_at(py + 1, px + 2, v);
      o01 = dot(v, 1, 0, o01), o11 = dot(v, 2, 0, o11);
      u1_at(py + 2, px + 1, v);
      o10 = dot(v, 0, 1, o10), o11 = dot(v, 0, 2, o11);
      u1_at(py + 2, px + 2, v);
      o11 = dot(v, 0, 0, o11);
      float* out = st.cost + static_cast<size_t>(bi) * 4 * hw + (2 * static_cast<size_t>(y)) * 2 * w + 2 * x;
      store2(out, o00, o01);
      store2(out + 2 * w, o10, o11);
    } else {
      float o = bh;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          u1_at(py + ky, px + kx, v);
          o = dot(v, ky, kx, o);
        }
      st.cost[bi * hw + static_cast<size_t>(y) * w + x] = o;
    }
  }
}

// The three launches of a depth step: per phase its kernel, grid, tile and
// shared memory. Phase A's tile follows the volume's width; phases B and C
// take their larger tile where it gives every SM a block, else a smaller one,
// so that small frames (the eval step's first stage) still fill the card.
struct Plan {
  void (*fn[3])(Step, Weights);
  dim3 grid[3];
  int tile[3][2];
  size_t smem[3];
};

template <typename L, typename K>
void set_phase(Plan& p, int i, K kernel, int h, int w, int B) {
  p.fn[i] = kernel;
  p.grid[i] = dim3(cdiv(w, L::TX), cdiv(h, L::TY), B);
  p.tile[i][0] = L::TY;
  p.tile[i][1] = L::TX;
  p.smem[i] = L::bytes;
}

template <int BASE, int CP, int UP>
cudaError_t make_plan(int B, int h, int w, Plan& p) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int hh = h / 2, wh = w / 2;
  set_phase<LayoutA<BASE, CP>>(p, 0, phase_a<BASE, CP>, h, w, B);
  if (cdiv(wh, 16) * cdiv(hh, 8) * B >= sms)
    set_phase<LayoutB<BASE, 8, 16>>(p, 1, phase_b<BASE, 8, 16>, hh, wh, B);
  else
    set_phase<LayoutB<BASE, 4, 8>>(p, 1, phase_b<BASE, 4, 8>, hh, wh, B);
  constexpr int CY = UP ? 16 : 32;  // the 2x head's outputs favour the shorter tile
  if (cdiv(w, 32) * cdiv(h, CY) * B >= sms)
    set_phase<LayoutC<BASE, CY, 32>>(p, 2, phase_c<BASE, UP, CY, 32>, h, w, B);
  else
    set_phase<LayoutC<BASE, 8, 16>>(p, 2, phase_c<BASE, UP, 8, 16>, h, w, B);
  for (int i = 0; i < 3; ++i)
    if ((e = tc::allow_smem(p.fn[i], p.smem[i])) != cudaSuccess) return e;
  return cudaSuccess;
}

// The recurrence over D depth steps, or with `info` only the plan: per phase
// grid x, y, z, tile rows, tile columns, shared bytes and blocks per SM.
template <int BASE, int CP, int UP>
int run(int cin, int D, int B, int h, int w, const float* vol, const Weights& wt, float* cost,
        float* scratch, cudaStream_t s, int* info) {
  Plan p;
  cudaError_t e = make_plan<BASE, CP, UP>(B, h, w, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (info) {
    for (int i = 0; i < 3; ++i) {
      int* o = info + 7 * i;
      o[0] = p.grid[i].x, o[1] = p.grid[i].y, o[2] = p.grid[i].z;
      o[3] = p.tile[i][0], o[4] = p.tile[i][1], o[5] = static_cast<int>(p.smem[i]);
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(o + 6, p.fn[i], kThreads, p.smem[i]);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
  }
  const int hh = h / 2, wh = w / 2;
  const size_t n1 = static_cast<size_t>(B) * h * w * BASE;
  const size_t n2 = static_cast<size_t>(B) * hh * wh * 2 * BASE;
  float* h1[2] = {scratch, scratch + n1};
  float* h2[2] = {scratch + 2 * n1, scratch + 2 * n1 + n2};
  const size_t out = static_cast<size_t>(B) * h * w * (UP ? 4 : 1);
  for (int d = 0; d < D; ++d) {
    const int q = d & 1;
    const Step st{vol + static_cast<size_t>(d) * B * cin * h * w, h1[q], h2[q], h1[1 - q], h2[1 - q],
                  cost + d * out, cin, h, w, d == 0};
    for (int i = 0; i < 3; ++i) p.fn[i]<<<p.grid[i], kThreads, p.smem[i], s>>>(st, wt);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int BASE, int CP>
int run_up(int cin, int up, int D, int B, int h, int w, const float* vol, const Weights& wt,
           float* cost, float* scratch, cudaStream_t s, int* info) {
  return up ? run<BASE, CP, 1>(cin, D, B, h, w, vol, wt, cost, scratch, s, info)
            : run<BASE, CP, 0>(cin, D, B, h, w, vol, wt, cost, scratch, s, info);
}

template <int BASE>
int run_cin(int cin, int up, int D, int B, int h, int w, const float* vol, const Weights& wt,
            float* cost, float* scratch, cudaStream_t s, int* info) {
  if (cin < 1) return adamvs::kBadChannels;
  if (cin <= 8) return run_up<BASE, 8>(cin, up, D, B, h, w, vol, wt, cost, scratch, s, info);
  if (cin <= 16) return run_up<BASE, 16>(cin, up, D, B, h, w, vol, wt, cost, scratch, s, info);
  if (cin <= 32) return run_up<BASE, 32>(cin, up, D, B, h, w, vol, wt, cost, scratch, s, info);
  if (cin <= 64) return run_up<BASE, 64>(cin, up, D, B, h, w, vol, wt, cost, scratch, s, info);
  return adamvs::kBadChannels;
}

int run_base(int base, int cin, int up, int D, int B, int h, int w, const float* vol,
             const Weights& wt, float* cost, float* scratch, cudaStream_t s, int* info) {
  switch (base) {
    case 4: return run_cin<4>(cin, up, D, B, h, w, vol, wt, cost, scratch, s, info);
    case 8: return run_cin<8>(cin, up, D, B, h, w, vol, wt, cost, scratch, s, info);
    default: return adamvs::kBadBase;
  }
}

}  // namespace f32

}  // namespace

// K3 in float32 on the tensor cores (split TF32): the whole recurrence of one
// stage, three launches per depth step. Split B fragments wc1, wg1, wn1, wc2,
// wg2, wn2, wu1 and float32 bg1, bn1, bg2, bn2, bu1, wh, bh (ops/red_scan.py::
// pack_red_fragments_tf32). Returns 0 or the first launch error.
extern "C" int adamvs_red_scan_f32(int base, int cin, int up, int D, int B, int h, int w,
                                   const void* vol, const void* wc1, const void* wg1,
                                   const void* wn1, const void* wc2, const void* wg2,
                                   const void* wn2, const void* wu1, const void* bg1,
                                   const void* bn1, const void* bg2, const void* bn2,
                                   const void* bu1, const void* wh, const void* bh, void* cost,
                                   void* scratch, void* stream) {
  const f32::Weights wt{
      static_cast<const uint4*>(wc1), static_cast<const uint4*>(wg1),
      static_cast<const uint4*>(wn1), static_cast<const uint4*>(wc2),
      static_cast<const uint4*>(wg2), static_cast<const uint4*>(wn2),
      static_cast<const uint4*>(wu1), static_cast<const float*>(bg1),
      static_cast<const float*>(bn1), static_cast<const float*>(bg2),
      static_cast<const float*>(bn2), static_cast<const float*>(bu1),
      static_cast<const float*>(wh), static_cast<const float*>(bh)};
  return f32::run_base(base, cin, up, D, B, h, w, static_cast<const float*>(vol), wt,
                       static_cast<float*>(cost), static_cast<float*>(scratch),
                       static_cast<cudaStream_t>(stream), nullptr);
}

// The float32 form's launches for one stage's shapes, without running them:
// info[7 i ..] for phase i (A, B, C) = grid x, y, z, tile rows, tile columns,
// shared bytes, blocks per SM. Returns 0 or an error.
extern "C" int adamvs_red_scan_f32_plan(int base, int cin, int up, int B, int h, int w, void* info) {
  return f32::run_base(base, cin, up, 1, B, h, w, nullptr, f32::Weights{}, nullptr, nullptr, nullptr,
                       static_cast<int*>(info));
}

// K3 in bfloat16 on the tensor cores: the whole recurrence of one stage, three
// launches per depth step. Fragments wc1, wg1, wn1, wc2, wg2, wn2, wu1 and
// float32 bg1, bn1, bg2, bn2, bu1, wh, bh (ops/red_scan.py::
// pack_red_fragments). Returns 0 or the first launch error.
extern "C" int adamvs_red_scan_bf16(int base, int cin, int up, int D, int B, int h, int w,
                                    const void* vol, const void* wc1, const void* wg1,
                                    const void* wn1, const void* wc2, const void* wg2,
                                    const void* wn2, const void* wu1, const void* bg1,
                                    const void* bn1, const void* bg2, const void* bn2,
                                    const void* bu1, const void* wh, const void* bh, void* cost,
                                    void* scratch, void* stream) {
  using tc::bf16;
  const tc::Weights wt{
      static_cast<const uint32_t*>(wc1), static_cast<const uint32_t*>(wg1),
      static_cast<const uint32_t*>(wn1), static_cast<const uint32_t*>(wc2),
      static_cast<const uint32_t*>(wg2), static_cast<const uint32_t*>(wn2),
      static_cast<const uint32_t*>(wu1), static_cast<const float*>(bg1),
      static_cast<const float*>(bn1), static_cast<const float*>(bg2),
      static_cast<const float*>(bn2), static_cast<const float*>(bu1),
      static_cast<const float*>(wh), static_cast<const float*>(bh)};
  const bf16* v = static_cast<const bf16*>(vol);
  bf16* c = static_cast<bf16*>(cost);
  bf16* sc = static_cast<bf16*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (base) {
    case 4: return tc::run_cin<4>(cin, up, D, B, h, w, v, wt, c, sc, s);
    case 8: return tc::run_cin<8>(cin, up, D, B, h, w, v, wt, c, sc, s);
    default: return adamvs::kBadBase;
  }
}
