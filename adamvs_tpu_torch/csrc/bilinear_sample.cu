// Bilinear sampling of NHWC features at given pixel coordinates: kernel K6/K7.
//
// Replaces two Pallas kernels that compute the same function in two TPU
// layouts:
//   K6 adamvs_tpu/ops/warp_pallas2.py::banded_bilinear_sample_pallas2 (:178,
//      pallas_call :298, body _sample_kernel2 :102), merged-lane bands;
//   K7 adamvs_tpu/ops/warp_pallas.py::banded_bilinear_sample_pallas (:89,
//      pallas_call :159, body _sample_kernel :33), channel-first bands.
// Both sample feat [B,H,W,C] at (u, v) [B,N,h,w] with zeros padding and give
// [B,N,h,w,C] in the feature dtype; exact form adamvs_tpu/ops/warp.py::
// bilinear_sample. The scan forms call it once per hypothesis slice with
// every source view in the batch axis (N = 1, and N = 16 in the blocks of
// AdaMVS's stage-1 correlation).
//
// What bounds it on an H100: bytes. Per sample it reads u and v (8 bytes),
// four taps of C channels (mostly from L2: neighbouring output pixels sample
// neighbouring source pixels, so the source is read from device memory about
// once) and writes C channels, against 8C + 10 float32 operations.
//
// Design: one thread per (b, n, output pixel, channel group of CB = 32, 16
// or 8). The thread computes floor(u), floor(v) and the four hat weights
// exactly as the plain version does (common.cuh::bilinear_tap_set, shared
// with the sweep kernels), reads each valid tap's CB channels as 16-byte
// vectors, accumulates in float32 and writes its CB channels as 16-byte
// vectors. The row width C is a runtime multiple of 8 (the wrapper pads any
// other width with zeros, ops/warp_sample.py::sample_width) and the group
// width the largest of 32, 16, 8 that divides it, so one instance per group
// width serves every C. The TPU kernels' band DMAs and hat-function matmuls
// are TPU artefacts and are not copied: the gather is exact for every
// sample, where a TPU kernel zeroes taps outside its band.
//
// Layouts: feat [B,H,W,C] float32 or bfloat16, u/v [B,N,h,w] float32,
// out [B,N,h,w,C] in the feature dtype, or float32 from bfloat16 features:
// the JAX pallas2bf16 mode on a float32 model rounds the features to bf16,
// samples them with float32 sums and returns float32
// (adamvs_tpu/ops/warp_pallas2.py:190-194, 221-222). That form is the same
// kernel with its output type a template parameter of its own; it reads half
// the bytes of the float32 form and writes as many. Its backward is the
// float32 form of K6/K7-bwd below (the cotangent is float32), whose
// gradient the wrapper rounds to bf16 once.
//
// K6/K7-bwd, the gradient of the same function with respect to feat, is the
// second entry below (adamvs_bilinear_sample_bwd). JAX has no Pallas
// backward for K6/K7: it trains the scan form through XLA autodiff of the
// gather warp (adamvs_tpu/ops/warp.py::bilinear_sample, the coordinates
// under stop_gradient), and the port's scan form samples through K6/K7, so
// its training form needs this kernel. It computes the exact transpose of
// the forward: dfeat[b, tap] += w_tap * dout[b, n, pixel] over every sample
// and valid tap, with the forward's taps and weights (common.cuh::
// bilinear_tap_grid, the same arithmetic as bilinear_tap_set).
//
// What bounds it on an H100: bytes (dout, u and v read once, dfeat written
// once; 1.02 ms per scan-form train step at 3.35 TB/s). The scan forms call
// it once per hypothesis slice with every source view in the batch axis
// (models/adamvs.py::fused_slice, correlation_volumes; models/msrednet.py::
// variance_slice): N = 1 hypothesis per call, and N = 16 in the blocks of
// AdaMVS's stage-1 correlation.
//
// The first design (one thread per sample and channel group, four taps of
// float4 atomics into L2 for every sample) took 6.47 ms per train step, 6.3x
// the bound, worst where N = 16 (1.40 ms against 0.152: each source pixel
// took ~64 read-modify-writes in L2) and with the calls of one view each too
// small to fill the card (PERF.md §6). This design combines the
// contributions on chip, so that dfeat is reached about once per touched
// source pixel and group of 8 channels:
//   - N = 1 (sample_bwd_tile_kernel): a warp takes a tile of 8 x 8 output
//     pixels (two samples a lane) of one image and 8 channels. It reduces
//     its samples' in-image taps to a box of the source (from the taps
//     themselves: the homography is not affine, samples behind the camera
//     sit at -1e9 and samples with no tap in the image do not count) and, if
//     the box fits kBoxCap pixels, accumulates in it in shared memory, then
//     adds each pixel of the box that some tap reached to dfeat as two
//     float4 reductions. Shared float atomics are compare-and-swap loops on
//     sm_90 (ATOMS.CAST.SPIN, the tiled K5), so there are none: the box is
//     the warp's own, the taps go in four passes (tap k of every sample)
//     with __syncwarp between them, and lanes whose samples share a tap
//     corner (a magnifying warp) hand their values to the lowest of them by
//     shuffles, which alone adds them. One __match_any_sync per sample finds
//     them for all four taps. A box larger than kBoxCap (a strong warp
//     scale, the horizon) sends that tile's taps to dfeat directly, as the
//     first design did.
//     chip_smoke.py --ablate sample_bwd times text-edited copies in turns at
//     one train step's calls; on an H100 (700 W), the card's busy time per
//     step, the wrapper's zeroing included: 2.46 ms as built, 4.87 with every
//     tile sent the direct way, 2.14 without the box's flush, 2.40 without
//     the match, 2.48 / 2.50 / 2.38 / 2.66 with tiles of 32x2 / 16x4 / 8x4 /
//     8x16 samples, 0.61 with empty kernels (the zeroing and launches).
//   - N > 1 (sample_bwd_walk_kernel): a thread takes one output pixel and 8
//     channels and walks its N samples in order, as K1 and K5-corr walk
//     theirs (common.cuh::staying, move_bits, move_values). It holds the 2x2
//     tap set's sums in registers and adds a held tap to dfeat only when the
//     walk leaves it; consecutive hypotheses move by less than a pixel over
//     most of the range.
// Sums are in float32 (a bf16 cotangent is read as bf16); the wrapper zeroes
// dfeat and rounds it once to the feature dtype. The order of the
// reductions in device memory varies from run to run, so the result is not
// bitwise reproducible: it agrees with the plain version to float32
// rounding of a few sums per pixel (chip_smoke.py holds it to 1e-5 relative
// L2).

#include <climits>

#include "common.cuh"

namespace {

using adamvs::Row;

constexpr int kThreads = 128;
// the forward's dtype code of bfloat16 features sampled into float32 (codes 0
// and 1, adamvs::kFloat32 and kBFloat16, sample into the feature dtype)
constexpr int kBFloat16ToFloat32 = 2;

template <typename T, typename To, int CB>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ feat, const float* __restrict__ u, const float* __restrict__ v,
              To* __restrict__ out, int N, int hw, int H, int W, int C) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int bn = blockIdx.y;  // b * N + n
  const int c0 = blockIdx.z * CB;
  const size_t i = static_cast<size_t>(bn) * hw + pix;
  const T* src = feat + static_cast<size_t>(bn / N) * H * W * C + c0;
  const adamvs::Taps t = adamvs::bilinear_tap_set(H, W, u[i], v[i]);
  float acc[CB], vals[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.idx[k] >= 0) {  // the valid taps summed in order
      Row<T, CB>::load(src + static_cast<size_t>(t.idx[k]) * C, vals);
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(vals[c], t.w[k]));
    }
  }
  Row<To, CB>::store(out + i * C + c0, acc);
}

template <typename T, typename To, int CB>
int launch(int B, int N, int hw, int H, int W, int C, const void* feat, const void* u,
           const void* v, void* out, cudaStream_t s) {
  const dim3 grid((hw + kThreads - 1) / kThreads, B * N, C / CB);
  sample_kernel<T, To, CB><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feat), static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<To*>(out), N, hw, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// The widest channel group that divides C (a multiple of 8).
template <typename T, typename To>
int for_channels(int C, int B, int N, int hw, int H, int W, const void* feat, const void* u,
                 const void* v, void* out, cudaStream_t s) {
  if (C <= 0 || C % 8) return adamvs::kBadChannels;
  if (C % 32 == 0) return launch<T, To, 32>(B, N, hw, H, W, C, feat, u, v, out, s);
  if (C % 16 == 0) return launch<T, To, 16>(B, N, hw, H, W, C, feat, u, v, out, s);
  return launch<T, To, 8>(B, N, hw, H, W, C, feat, u, v, out, s);
}

// --- K6/K7-bwd ----------------------------------------------------------------

constexpr int kGroup = 8;      // channels a thread or warp takes: two float4 of dfeat
constexpr int kWarps = 4;      // warps (independent tiles) per tile block
constexpr int kTileW = 8;      // a warp's lanes cover kTileW x (32 / kTileW) output pixels
constexpr int kSteps = 2;      // ... kSteps times, one below the other: a tile
constexpr int kTileH = 32 / kTileW * kSteps;
constexpr int kBoxCap = 160;   // source pixels a warp's box may hold in shared memory
constexpr unsigned kFull = 0xffffffffu;

// dst[0..7] += a[0..7] as two float4 reductions in device memory.
__device__ __forceinline__ void red_row8(float* dst, const float* a) {
  float4* q = reinterpret_cast<float4*>(dst);
  atomicAdd(q, make_float4(a[0], a[1], a[2], a[3]));
  atomicAdd(q + 1, make_float4(a[4], a[5], a[6], a[7]));
}

// One hypothesis plane per sample (N = 1): a warp takes kTileW x kTileH
// output pixels and one group of 8 channels of one image b, accumulates
// their taps in a box of the source in shared memory and adds the box to
// dfeat once (see the head of this file).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
sample_bwd_tile_kernel(const T* __restrict__ dout, const float* __restrict__ u,
                       const float* __restrict__ v, float* __restrict__ dfeat,
                       int* __restrict__ stats, int B, int h, int w, int H, int W, int C) {
  __shared__ float4 boxes[kWarps][kBoxCap * 2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = C / kGroup, tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  long long job = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (job >= static_cast<long long>(B) * tiles_y * tiles_x * G) return;  // the whole warp
  const int g = static_cast<int>(job % G);
  job /= G;
  const int x = static_cast<int>(job % tiles_x) * kTileW + lane % kTileW;
  job /= tiles_x;
  const int y0 = static_cast<int>(job % tiles_y) * kTileH + lane / kTileW;
  const int b = static_cast<int>(job / tiles_y);
  const size_t plane = static_cast<size_t>(b) * h * w;

  // the samples' taps and cotangents, and the box of their in-image taps
  adamvs::TapGrid t[kSteps];
  float gr[kSteps][kGroup];
  int xlo = INT_MAX, ylo = INT_MAX, xhi = -1, yhi = -1;
#pragma unroll
  for (int r = 0; r < kSteps; ++r) {
    const int y = y0 + r * (32 / kTileW);
    const bool in = x < w && y < h;
    const size_t i = plane + static_cast<size_t>(y) * w + x;
    // the cotangent is read with the coordinates, not after them, so that
    // the loads of a lane overlap
    if (in) {
      Row<T, kGroup>::load(dout + i * C + g * kGroup, gr[r]);
    } else {
#pragma unroll
      for (int c = 0; c < kGroup; ++c) gr[r][c] = 0.f;
    }
    t[r] = adamvs::bilinear_tap_grid(H, W, in ? u[i] : -1e9f, in ? v[i] : -1e9f);
    if (adamvs::any_tap(t[r])) {
      xlo = min(xlo, max(t[r].x0, 0)), xhi = max(xhi, min(t[r].x0 + 1, W - 1));
      ylo = min(ylo, max(t[r].y0, 0)), yhi = max(yhi, min(t[r].y0 + 1, H - 1));
    }
  }
  xlo = __reduce_min_sync(kFull, xlo), ylo = __reduce_min_sync(kFull, ylo);
  xhi = __reduce_max_sync(kFull, xhi), yhi = __reduce_max_sync(kFull, yhi);
  if (xhi < 0) return;  // no tap of the tile lies in the image
  const int bw = xhi - xlo + 1, bh = yhi - ylo + 1;
  const bool staged = bw * bh <= kBoxCap;
  if (stats != nullptr && lane == 0) atomicAdd(stats, 1), atomicAdd(stats + 1, staged ? 0 : 1);
  float* dst = dfeat + static_cast<size_t>(b) * H * W * C + g * kGroup;

  if (!staged) {  // the box exceeds shared memory: every tap straight to dfeat
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!t[r].ok[k]) continue;
        float a[kGroup];
#pragma unroll
        for (int c = 0; c < kGroup; ++c) a[c] = __fmul_rn(gr[r][c], t[r].w[k]);
        const int q = (t[r].y0 + (k >> 1)) * W + t[r].x0 + (k & 1);
        red_row8(dst + static_cast<size_t>(q) * C, a);
      }
    }
    return;
  }

  float4* box = boxes[warp];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = lane; j < 2 * bw * bh; j += 32) box[j] = zero;
  __syncwarp();
  // Per row of samples, lanes whose samples share a tap corner (a magnifying
  // warp) hand their values to the lowest of them by shuffles, which alone
  // adds them to the box; then tap k of every sample, one k at a time, so no
  // two lanes touch one shared word at once.
#pragma unroll
  for (int r = 0; r < kSteps; ++r) {
    const adamvs::TapGrid& tr = t[r];
    const int corner = adamvs::any_tap(tr) ? (tr.y0 + 1) * (W + 1) + tr.x0 + 1 : -1;
    const unsigned peers = __match_any_sync(kFull, corner);
    const bool leader = corner >= 0 && lane == __ffs(peers) - 1;
    const unsigned rest = leader ? peers & (peers - 1) : 0u;  // the others, lowest first
    const bool combine = __any_sync(kFull, rest);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float a[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) a[c] = __fmul_rn(gr[r][c], tr.w[k]);
      if (combine) {
        for (unsigned left = rest; __any_sync(kFull, left); left &= left - 1) {
          const int from = left ? __ffs(left) - 1 : lane;
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            const float o = __shfl_sync(kFull, a[c], from);
            if (left) a[c] = __fadd_rn(a[c], o);
          }
        }
      }
      if (leader && tr.ok[k]) {
        const int target = (tr.y0 + (k >> 1) - ylo) * bw + tr.x0 + (k & 1) - xlo;
        float4* p = box + 2 * target;
        const float4 p0 = p[0], p1 = p[1];
        p[0] = make_float4(__fadd_rn(p0.x, a[0]), __fadd_rn(p0.y, a[1]), __fadd_rn(p0.z, a[2]),
                           __fadd_rn(p0.w, a[3]));
        p[1] = make_float4(__fadd_rn(p1.x, a[4]), __fadd_rn(p1.y, a[5]), __fadd_rn(p1.z, a[6]),
                           __fadd_rn(p1.w, a[7]));
      }
      __syncwarp();
    }
  }
  // the box once into dfeat, skipping pixels no tap reached: lane j takes
  // half j & 1 of box pixel (bx, by), 16 pixels on per step
  int bx = (lane >> 1) % bw, by = (lane >> 1) / bw;
  for (int j = lane; j < 2 * bw * bh; j += 32) {
    const float4 a = box[j];
    if (a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f) {
      const size_t q = static_cast<size_t>(ylo + by) * W + xlo + bx;
      atomicAdd(reinterpret_cast<float4*>(dst + q * C) + (j & 1), a);
    }
    for (bx += 16; bx >= bw; bx -= bw) ++by;
  }
}

// N > 1 hypotheses per pixel (stage 1's blocks): a thread takes one output
// pixel and group of 8 channels of one image b and walks its N samples in
// order, holding the gradient of its current 2x2 tap set in registers; a
// held tap goes to dfeat only when the walk leaves it (see the head of this
// file).
constexpr int kWalkThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
sample_bwd_walk_kernel(const T* __restrict__ dout, const float* __restrict__ u,
                       const float* __restrict__ v, float* __restrict__ dfeat,
                       int* __restrict__ stats, int B, int N, int hw, int H, int W, int C) {
  const int G = C / kGroup;
  const long long id = static_cast<long long>(blockIdx.x) * kWalkThreads + threadIdx.x;
  if (id >= static_cast<long long>(B) * hw * G) return;
  const int g = static_cast<int>(id % G);
  const int pix = static_cast<int>((id / G) % hw);
  const int b = static_cast<int>(id / G / hw);
  float* dst = dfeat + static_cast<size_t>(b) * H * W * C + g * kGroup;
  // the held taps: corner (hx, hy), bits of the taps that hold a sum, and
  // per channel the four taps' sums
  int hx = 0, hy = 0, held = 0, flushes = 0;
  float acc[kGroup][4];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  // sample n + 1's coordinates and cotangent are read while sample n is
  // walked; one step past the last sample flushes what is held
  const size_t first = static_cast<size_t>(b) * N * hw + pix;
  float un = u[first], vn = v[first], gn[kGroup];
  Row<T, kGroup>::load(dout + first * C + g * kGroup, gn);
  for (int n = 0; n <= N; ++n) {
    float gv[kGroup];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) gv[c] = gn[c];
    const adamvs::TapGrid tg = adamvs::bilinear_tap_grid(H, W, n < N ? un : -1e9f,
                                                         n < N ? vn : -1e9f);
    if (n + 1 < N) {
      const size_t i = first + static_cast<size_t>(n + 1) * hw;
      un = u[i], vn = v[i];
      Row<T, kGroup>::load(dout + i * C + g * kGroup, gn);
    }
    const bool some = adamvs::any_tap(tg);
    const int ddx = some ? tg.x0 - hx : 0, ddy = some ? tg.y0 - hy : 0;
    const int stay = some ? adamvs::staying(ddx, ddy) : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(held >> j & 1) || (stay >> j & 1)) continue;
      float a[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) a[c] = acc[c][j];
      red_row8(dst + (static_cast<size_t>(hy + (j >> 1)) * W + hx + (j & 1)) * C, a);
      ++flushes;
    }
    held = adamvs::move_bits(held & stay, ddx, ddy);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) adamvs::move_values(acc[c], ddx, ddy);
    const int taps = adamvs::walk_taps(tg);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool kept = held >> k & 1, add = taps >> k & 1;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const float base = kept ? acc[c][k] : 0.f;
        acc[c][k] = add ? fmaf(gv[c], tg.w[k], base) : base;
      }
    }
    held |= taps;
    hx = tg.x0, hy = tg.y0;
  }
  // the samples walked and the flushes
  if (stats != nullptr) adamvs::add_walk_counts(stats, N, flushes);
}

template <typename T>
int launch_bwd(int B, int N, int h, int w, int H, int W, int C, const void* dout, const void* u,
               const void* v, void* dfeat, int* stats, cudaStream_t s) {
  if (C <= 0 || C % kGroup) return adamvs::kBadChannels;
  const T* g = static_cast<const T*>(dout);
  const float *pu = static_cast<const float*>(u), *pv = static_cast<const float*>(v);
  float* df = static_cast<float*>(dfeat);
  const long long G = C / kGroup;
  if (N == 1) {
    const long long jobs = static_cast<long long>(B) * ((h + kTileH - 1) / kTileH) *
                           ((w + kTileW - 1) / kTileW) * G;
    const unsigned blocks = static_cast<unsigned>((jobs + kWarps - 1) / kWarps);
    if (blocks == 0) return 0;
    sample_bwd_tile_kernel<T><<<blocks, kWarps * 32, 0, s>>>(g, pu, pv, df, stats, B, h, w, H,
                                                              W, C);
  } else {
    const long long threads = static_cast<long long>(B) * h * w * G;
    const unsigned blocks = static_cast<unsigned>((threads + kWalkThreads - 1) / kWalkThreads);
    if (blocks == 0) return 0;
    sample_bwd_walk_kernel<T><<<blocks, kWalkThreads, 0, s>>>(g, pu, pv, df, stats, B, N,
                                                               h * w, H, W, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6/K7 on features of C channels, a multiple of 8: float32 into float32
// (dtype 0), bfloat16 into bfloat16 (1) or bfloat16 into float32 (2).
// Returns 0 or the launch error.
extern "C" int adamvs_bilinear_sample(int dtype, int B, int N, int h, int w, int H, int W, int C,
                                      const void* feat, const void* u, const void* v, void* out,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32)
    return for_channels<float, float>(C, B, N, h * w, H, W, feat, u, v, out, s);
  if (dtype == adamvs::kBFloat16)
    return for_channels<__nv_bfloat16, __nv_bfloat16>(C, B, N, h * w, H, W, feat, u, v, out, s);
  if (dtype == kBFloat16ToFloat32)
    return for_channels<__nv_bfloat16, float>(C, B, N, h * w, H, W, feat, u, v, out, s);
  return adamvs::kBadDtype;
}

// K6/K7-bwd: dfeat [B,H,W,C] float32, zeroed by the caller, gets the
// gradient of the sampling for the cotangent dout [B,N,h,w,C] in the
// feature dtype (C a multiple of 8). stats (int[2] or null) counts: with N 1,
// the warp tiles that reached the image in stats[0] and those whose box
// exceeded shared memory in stats[1]; with N > 1, the samples walked per
// thread in stats[0] and the held taps flushed in stats[1]. Returns 0 or the
// launch error.
extern "C" int adamvs_bilinear_sample_bwd(int dtype, int B, int N, int h, int w, int H, int W,
                                          int C, const void* dout, const void* u, const void* v,
                                          void* dfeat, void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* st = static_cast<int*>(stats);
  if (dtype == adamvs::kFloat32)
    return launch_bwd<float>(B, N, h, w, H, W, C, dout, u, v, dfeat, st, s);
  if (dtype == adamvs::kBFloat16)
    return launch_bwd<__nv_bfloat16>(B, N, h, w, H, W, C, dout, u, v, dfeat, st, s);
  return adamvs::kBadDtype;
}
