// Backward of the plane-sweep volumes: kernel K5, the training forms.
//
// Replaces the custom VJPs of adamvs_tpu/ops/sweep_fuse.py:
//   fused_sweep_volume_t (:786, backward _fused_t_bwd :810),
//   var_sweep_volume_t (:832, backward _var_t_bwd :854),
//   corr_sweep_volume_t (:874, backward _corr_t_bwd :894).
// Their forwards are the K2/K4/K1 Pallas call (sweep_fuse.cu here); their
// backwards are jax.vjp of the exact gather forms _xla_fused_volume (:725),
// _xla_var_volume (:743) and _xla_corr_volume (:763), recomputed. The sample
// positions carry no gradient, so only ref, the sources and the weights get
// one.
//
// With hyp_d = lo + d*step, X_v the bilinear sample of source v at hyp_d and
// T_v its transpose (a C-row scattered onto the four taps with their
// weights), for a cotangent g of the volume:
//   corr  (g [Vs,B,D,h,w] float32):
//         dref = sum_v sum_d g X_v / C;  dsrc_v += T_v(g ref / C)
//   fused (g [D,B,C,h,w], the feature dtype; wn [B,Vs,h,w] normalised):
//         dref = sum_d sum_v g wn_v X_v;  dwn_v = sum_d sum_c g ref X_v;
//         dsrc_v += T_v(g ref wn_v)
//   var   (g [D,B,C,h,w]; nv = Vs+1, m = (ref + sum_v X_v) / nv):
//         dref = sum_d g (2/nv)(ref - m);  dsrc_v += T_v(g (2/nv)(X_v - m))
//
// What bounds fused and var on an H100: the forward's tap arithmetic again (the
// samples X_v are recomputed, for dref, dwn and the variance mean) plus one
// multiply-add per tap, channel and scatter target, at 67 TFLOP/s float32;
// at the full-resolution stage the bytes of g, ref, the sources and the
// gradients, each moved once in its own dtype.
//
// corr (corr_walk_bwd_kernel): the walk of the forward K1 (sweep_fuse.cu).
// What bounds it: its bytes (g, ref, the sources, the gradients, each moved
// once: 0.011 ms per train step at 3.35 TB/s). A kernel that scattered every
// tap of every sample as C/4 float4 atomics into L2 (~113 M per train step)
// spent most of its time in them. With g_d / C the cotangent of sample d, the
// gradient of sum_k w_k (ref . s_k) / C is, per source pixel q that a tap
// touches, a_q = sum of w_k g_d / C over the samples and taps k that land on
// q, then d src_q += a_q ref and d ref += a_q s_q: one C-wide scatter and one
// C-wide multiply-add per source pixel, not per tap and sample.
//   - A thread owns one (view, batch, reference pixel) and a run of kRun
//     hypotheses, walked in order as in K1 (common.cuh::sweep_position,
//     bilinear_tap_grid, walk_taps, staying, move_bits, move_values). It
//     holds the 2x2 tap set's coefficients a_q; a tap that counts adds
//     w_k g_d / C to its coefficient, whether the tap was held or is new.
//   - A held tap whose pixel leaves the set, and every held tap at the end of
//     the run or at a sample behind the camera or with no tap in the image,
//     is flushed if its coefficient is not 0: d src_q += a_q ref as C/4
//     float4 atomics into the zeroed float32 d srcs (L2), and the thread's
//     d ref (C floats in registers) += a_q s_q from a C-wide load of the
//     source row. ref is read again at each flush (from L1), which keeps the
//     float32 C32 instance within 128 registers.
//   - The flushes stay global atomics. Left out, they take ~0.15 ms per
//     train step off the kernel (chip_smoke.py --ablate corr_bwd, PERF.md):
//     all that shared-memory accumulator windows could win back, before
//     their boxes, barriers and compare-and-swap adds (the tiled K5-fused
//     below), so they were not built. Runs of 16 hypotheses ran faster than
//     runs of 8 or 48 at the training shape, which has ~16x fewer (view,
//     pixel) pairs than the inference shape.
//   - d ref takes one float4 atomic row per (view, pixel, run).
//   - Everything sums in float32; the atomics' order varies from run to run.

// fused and var (sweep_bwd_tile_kernel). Direct kernels, one thread per
// (view, pixel, chunk of hypotheses), scattered every tap as C/4 float4
// atomics into L2, which held most of their time (PERF.md §6 gives the
// measurement).
// This kernel takes K2/K4's tile (sweep_fuse.cu::sweep_tile_kernel) and
// moves the scatter into shared memory:
//   - A 256-thread block owns a 32-wide tile of reference pixels (32x8 at C
//     8, 32x4 at 16, 32x2 at 32), one thread per pixel and 8
//     channels, for one batch and a chunk of kD hypotheses (8 for fused, 4
//     for var, whose variance mean takes kD x 8 registers).
//   - Per source view every thread computes its own pixel's kD sample
//     positions (the plain version's rounding order; again when it samples,
//     which leaves registers to the tap sums), the block reduces the box of
//     the in-image taps and stages that source
//     window with a ring of one pixel (zero outside the image) in shared
//     memory by cp.async, double-buffered across views, as K2/K4 do.
//   - d srcs accumulates in a float32 window of the same box and ring in
//     shared memory: every sample adds w_k * row at its four taps with scalar
//     shared atomic adds (fused: row = g ref w'_v; var: g (2/nv)(X_v - m)).
//     A tap outside the image lands on the ring and is dropped. Neighbouring
//     threads of a warp hit neighbouring window pixels, so the channel slots
//     of window pixel q are rotated by q >> kRotShift: the 32 lanes of one
//     atomic hit 32 different banks where their pixels are consecutive.
//     These float adds compile to compare-and-swap loops on sm_90
//     (ATOMS.CAST.SPIN; there is no native shared-memory float add), so the
//     scatter saves them: a lane hands its right tap column to its right
//     neighbour where that is the neighbour's left column, and sums its left
//     column in registers while its tap set stays (sample() below).
//   - When the view is done the block flushes each in-image window pixel
//     once into the global float32 d srcs, as float4 atomics of 4 channels
//     (skipping all-zero ones), and zeroes the window for the next view. A
//     window of a few hundred pixels takes the kD x pixels x 4 taps of its
//     samples, so the flush replaces ~10-20 global atomics per window pixel.
//   - var takes two passes over the views per chunk: the mean m of {ref,
//     X_1 .. X_Vs}, summed in the forward's order (ref, then the views) in
//     registers, then the scatter, which stages each view's window again.
//     Keeping all Vs windows resident instead does not fit: Vs 4 float32 C32
//     windows and the accumulator exceed a block's shared memory, and two
//     blocks per SM are needed to hide the chain of barriers and copies.
//     A version whose mean pass read its taps from device memory instead
//     (no windows, no barriers) ran slower on an H100.
//   - d ref and d weights take one float32 atomic per (pixel, chunk): a
//     thread sums its 8 channels' d ref over the chunk's hypotheses and the
//     views, and its share of d w'_v per view.
//   - A window whose source or accumulator exceeds kWindowBytes / kAccBytes
//     (a depth edge or a steep view spreads the taps) is not staged: that
//     view's samples gather their in-image taps from device memory and
//     scatter them with float4 atomics there, the same taps in the same order.
//   - Everything sums in float32; the wrapper casts the results to the
//     primal dtypes. The order of the atomics varies from run to run, so the
//     results are not bitwise reproducible.
// Shared memory per block: two source windows of kWindowBytes, the
// accumulator window of kAccBytes, the geometry and the boxes (~110 KB, two
// blocks per SM). The kernels take an optional int[2] `stats`: when it is
// not null, each block adds, per source window it prepares (per view, and
// twice per view for var), 1 to stats[0] and, if the window was not staged,
// 1 to stats[1].
//
// Widths: every mode launches at C 8, 16 and 32; the wrappers
// (ops/sweep_fuse.py::sweep_plan) pad narrower features and run wider ones
// as channel groups of 32.
//
// Layouts as the forward's: ref [B,h,w,C], src [Vs,B,H,W,C] (float32 or
// bfloat16), geom [Vs*B,12] float32, lo/step [B,h,w] float32.

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using adamvs::cp_async16;
using adamvs::cp_async_commit;
using adamvs::cp_async_wait;
using adamvs::load8_shared;
using adamvs::Row;
using adamvs::to_f32;
using adamvs::Window;

constexpr int kMaxViews = 16;

// dst[0..C) += v[0..C) (float32, 16-byte aligned) as float4 vector atomics,
// which sm_90 offers on global memory.
template <int C>
__device__ __forceinline__ void atomic_add_row(float* dst, const float* v) {
  float4* q = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < C / 4; ++i)
    atomicAdd(q + i, make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
}

// --- corr: the walk ----------------------------------------------------------

constexpr int kWalkThreads = 128;
constexpr int kRun = 16;  // hypotheses a thread walks

template <typename T, int C>
__global__ void __launch_bounds__(kWalkThreads, 4)
corr_walk_bwd_kernel(const float* __restrict__ gout, const T* __restrict__ ref,
                     const T* __restrict__ src, const float* __restrict__ geom,
                     const float* __restrict__ lo, const float* __restrict__ step,
                     float* __restrict__ dref, float* __restrict__ dsrc, int* __restrict__ stats,
                     int B, int h, int w, int H, int W, int D) {
  const int hw = h * w;
  const int pix = blockIdx.x * kWalkThreads + threadIdx.x;
  const int vb = blockIdx.y;  // v * B + b
  const int b = vb % B;
  __shared__ float g[12];
  if (threadIdx.x < 12) g[threadIdx.x] = geom[vb * 12 + threadIdx.x];
  __syncthreads();
  if (pix >= hw) return;
  const size_t bp = static_cast<size_t>(b) * hw + pix;
  // d ref in registers; ref itself is read again at each flush (L1), which
  // leaves the registers to d ref
  const T* rp = ref + bp * C;
  float a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = 0.f;
  float rxyz[3];
  adamvs::rot_xyz(g, static_cast<float>(pix % w), static_cast<float>(pix / w), rxyz);
  const float t[3] = {g[9], g[10], g[11]};
  const float l = lo[bp], st = step[bp];
  const size_t view = static_cast<size_t>(vb) * H * W * C;  // one view, < 2^31 elements
  const T* s = src + view;
  float* ds = dsrc + view;
  const int d0 = blockIdx.z * kRun, d1 = min(D, d0 + kRun);
  const float* gp = gout + (static_cast<size_t>(vb) * D + d0) * hw + pix;
  // the held tap set: corner (hx, hy) and each tap's coefficient (0: nothing
  // to flush)
  int hx = 0, hy = 0, flushes = 0;
  float coef[4] = {0.f, 0.f, 0.f, 0.f};
  // one step past the run flushes what is held
  for (int d = d0; d <= d1; ++d, gp += hw) {
    float2 uv = make_float2(-1e9f, -1e9f);  // past the run: no tap
    float gd = 0.f;
    if (d < d1) {
      gd = __fdiv_rn(*gp, static_cast<float>(C));
      uv = adamvs::sweep_position(rxyz, t, __fadd_rn(l, __fmul_rn(static_cast<float>(d), st)));
    }
    const adamvs::TapGrid c = adamvs::bilinear_tap_grid(H, W, uv.x, uv.y);
    const bool some = adamvs::any_tap(c);
    const int ddx = some ? c.x0 - hx : 0, ddy = some ? c.y0 - hy : 0;
    const int stay = some ? adamvs::staying(ddx, ddy) : 0;
    // flush the held taps that leave: d src_q += a_q ref, d ref += a_q s_q
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      const float aq = adamvs::pick4(coef, j);
      if ((stay >> j & 1) || aq == 0.f) continue;
      const int q = ((hy + (j >> 1)) * W + hx + (j & 1)) * C;
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
        float v[8], rv[8];
        Row<T, 8>::load(s + q + 8 * i, v);
        Row<T, 8>::load(rp + 8 * i, rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) a[8 * i + e] = fmaf(aq, v[e], a[8 * i + e]);
        float4* dq = reinterpret_cast<float4*>(ds + q + 8 * i);
        atomicAdd(dq, make_float4(__fmul_rn(aq, rv[0]), __fmul_rn(aq, rv[1]),
                                  __fmul_rn(aq, rv[2]), __fmul_rn(aq, rv[3])));
        atomicAdd(dq + 1, make_float4(__fmul_rn(aq, rv[4]), __fmul_rn(aq, rv[5]),
                                      __fmul_rn(aq, rv[6]), __fmul_rn(aq, rv[7])));
      }
      ++flushes;
    }
    // the staying taps' coefficients at their new index, the new taps' from 0
    adamvs::move_values(coef, ddx, ddy);
    const int kept = adamvs::move_bits(stay, ddx, ddy);
    const int taps = adamvs::walk_taps(c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(kept >> k & 1)) coef[k] = 0.f;
      if (taps >> k & 1) coef[k] = fmaf(c.w[k], gd, coef[k]);
    }
    hx = c.x0, hy = c.y0;
  }
  if (flushes) atomic_add_row<C>(dref + bp * C, a);
  // the samples walked and the flushes
  if (stats != nullptr) adamvs::add_walk_counts(stats, d1 - d0, flushes);
}

// --- fused and var: 2-D tiles with d srcs accumulated in shared memory -------

constexpr int kTileThreads = 256;
constexpr int kTileW = 32;
constexpr int kWindowBytes = 36 * 1024;  // one staged source window
constexpr int kAccBytes = 36 * 1024;     // the float32 d srcs window

// The shape of a fused (kVar false) or var (kVar true) block and its shared
// memory.
template <typename T, int C, bool kVar>
struct BwdTile {
  static constexpr int kLanes = C / 8;                   // threads per pixel, 8 channels each
  static constexpr int kPixels = kTileThreads / kLanes;  // pixels per tile
  static constexpr int kRows = kPixels / kTileW;
  static constexpr int kD = kVar ? 4 : 8;                // hypotheses per block
  static constexpr int kChunks = C * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per pixel
  static constexpr int kStride = kChunks | 1;  // 16-byte slots of a staged pixel (odd: no conflicts)
  // accumulator pixel q holds channel c in slot (c + (q >> kRotShift)) mod C:
  // 32 consecutive pixels' slots of one channel lie in 32 different banks
  static constexpr int kRotShift = C >= 32 ? 0 : (C == 16 ? 1 : 2);
  static constexpr size_t kAccOffset = 2 * static_cast<size_t>(kWindowBytes);
  static constexpr size_t kGeomOffset = kAccOffset + kAccBytes;
  static constexpr size_t kBoxOffset = kGeomOffset + kMaxViews * 12 * sizeof(float);
  static constexpr size_t kSmemBytes = kBoxOffset + 8 * sizeof(int);
  static_assert(kPixels % kTileW == 0, "a tile is whole rows of 32 pixels");
  static_assert(C == 8 || C == 16 || C == 32, "C is 8, 16 or 32");
};

// *p += v in shared memory, p a shared-memory address.
__device__ __forceinline__ void red_shared(unsigned p, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;\n" ::"r"(p), "f"(v));
}

template <typename T, int C, bool kVar>
__global__ void __launch_bounds__(kTileThreads, 2)
sweep_bwd_tile_kernel(const T* __restrict__ gout, const T* __restrict__ ref,
                      const T* __restrict__ src, const float* __restrict__ geom,
                      const float* __restrict__ lo, const float* __restrict__ step,
                      const float* __restrict__ wn, float* __restrict__ dref,
                      float* __restrict__ dwn, float* __restrict__ dsrc, int* __restrict__ stats,
                      int Vs, int B, int h, int w, int H, int W, int D) {
  using S = BwdTile<T, C, kVar>;
  constexpr int P = S::kPixels, KD = S::kD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_win = reinterpret_cast<float*>(smem + S::kAccOffset);  // [kAccBytes / 4]
  float* gm = reinterpret_cast<float*>(smem + S::kGeomOffset);     // [Vs*12]
  int* boxes = reinterpret_cast<int*>(smem + S::kBoxOffset);       // [2][4]

  const int tid = threadIdx.x;
  const int p = tid % P, grp = tid / P;
  // the hypothesis chunks of a tile are neighbouring blocks, so that they read
  // the tile's source footprint from L2
  const int ntile_y = (h + S::kRows - 1) / S::kRows;
  const int b = blockIdx.z / ntile_y;
  const int d0 = blockIdx.x * KD;
  const int tx0 = blockIdx.y * kTileW, ty0 = (blockIdx.z % ntile_y) * S::kRows;
  const int hw = h * w;
  for (int i = tid; i < Vs * 12; i += kTileThreads) gm[i] = geom[((i / 12) * B + b) * 12 + i % 12];
  // the accumulator starts zeroed; every flush leaves it zeroed again
  for (int i = tid; i < kAccBytes / 16; i += kTileThreads)
    reinterpret_cast<float4*>(acc_win)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < 8) boxes[tid] = tid % 4 < 2 ? INT_MAX : INT_MIN;  // steps 0 and 1: empty
  const int px = tx0 + p % kTileW, py = ty0 + p / kTileW;
  const bool own = px < w && py < h;
  const size_t pix = own ? static_cast<size_t>(py) * w + px : 0;
  const size_t bp = static_cast<size_t>(b) * hw + pix;
  const float lq = own ? lo[bp] : 0.f, sq = own ? step[bp] : 0.f;
  const size_t src_view = static_cast<size_t>(H) * W * C;
  const int nsteps = kVar ? 2 * Vs : Vs;  // var: the mean pass, then the scatter pass
  const float nv = static_cast<float>(Vs + 1);
  const float k2 = __fdiv_rn(2.f, nv);

  // fused: this thread's 8 reference channels and its d ref; var: s from ref,
  // then the mean (var loads ref and sums d ref only where it needs them,
  // which keeps its float32 instances within 128 registers)
  const T* ref_own = ref + bp * C + grp * 8;
  float r[kVar ? 1 : 8], a[kVar ? 1 : 8];
  float m[kVar ? KD : 1][8];
  {
    float r0[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (own) Row<T, 8>::load(ref_own, r0);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if constexpr (kVar) {
#pragma unroll
        for (int j = 0; j < KD; ++j) m[j][c] = r0[c];
      } else {
        r[c] = r0[c];
        a[c] = 0.f;
      }
    }
  }
  __syncthreads();  // gm, the accumulator, boxes

  // Step st's window from its box in shared memory (final once prepare(st)
  // passed its barrier), with a ring of one pixel.
  auto window_of = [&](int st) -> Window {
    const int* box = boxes + 4 * (st & 1);
    Window win{box[0] - 1, box[1] - 1, 0, 0, true};
    if (box[2] >= box[0]) {  // some tap lies in the image
      win.w = box[2] - box[0] + 3;
      win.h = box[3] - box[1] + 3;
      const long long n = static_cast<long long>(win.w) * win.h;
      win.staged = n * S::kStride * 16 <= kWindowBytes && n * C * 4 <= kAccBytes;
    }
    return win;
  };

  // This pixel's sample position at hypothesis d0 + j in view vv, in the
  // order of common.cuh::sweep_position: (-1e9, -1e9), no tap, behind the camera
  // (as the plain version) or past D. prepare() reduces the box from it and
  // sample() computes it again, which costs a few instructions per sample and
  // leaves the registers to the tap sums.
  auto position = [&](int vv, int j) -> float2 {
    const float* gv = gm + 12 * vv;
    const int d = d0 + j;
    float2 uv = make_float2(-1e9f, -1e9f);
    if (own && d < D) {
      float rxyz[3];
      adamvs::rot_xyz(gv, static_cast<float>(px), static_cast<float>(py), rxyz);
      uv = adamvs::sweep_position(rxyz, gv + 9,
                                  __fadd_rn(lq, __fmul_rn(static_cast<float>(d), sq)));
    }
    return uv;
  };

  // Box and copies of step st's window (buffers st & 1).
  auto prepare = [&](int st) {
    const int vv = st % Vs;
    int* box = boxes + 4 * (st & 1);
    // The taps of a sample at (u, v) are {u0, u0+1} x {v0, v0+1} (the floors)
    // cut to the image; some count exactly when -1 <= u < W and -1 <= v < H,
    // and the box of all of them is [max(floor(min u), 0), min(floor(max u) +
    // 1, W-1)] x (the same in v), over the samples that have some.
    const float fw = static_cast<float>(W), fh = static_cast<float>(H);
    float umin = 3e38f, vmin = 3e38f, umax = -3e38f, vmax = -3e38f;
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      const float2 uv = position(vv, j);
      if (uv.x >= -1.f && uv.x < fw && uv.y >= -1.f && uv.y < fh) {
        umin = fminf(umin, uv.x), umax = fmaxf(umax, uv.x);
        vmin = fminf(vmin, uv.y), vmax = fmaxf(vmax, uv.y);
      }
    }
    const bool none = umin > umax;
    int x0 = none ? INT_MAX : static_cast<int>(fmaxf(floorf(umin), 0.f));
    int x1 = none ? INT_MIN : static_cast<int>(fminf(floorf(umax) + 1.f, fw - 1.f));
    int y0 = none ? INT_MAX : static_cast<int>(fmaxf(floorf(vmin), 0.f));
    int y1 = none ? INT_MIN : static_cast<int>(fminf(floorf(vmax) + 1.f, fh - 1.f));
    x0 = __reduce_min_sync(0xffffffffu, x0);
    y0 = __reduce_min_sync(0xffffffffu, y0);
    x1 = __reduce_max_sync(0xffffffffu, x1);
    y1 = __reduce_max_sync(0xffffffffu, y1);
    if ((tid & 31) == 0) {
      atomicMin(box, x0), atomicMin(box + 1, y0), atomicMax(box + 2, x1), atomicMax(box + 3, y1);
    }
    __syncthreads();
    const Window win = window_of(st);
    if (win.staged && win.w > 0) {
      const unsigned char* sv = reinterpret_cast<const unsigned char*>(
          src + (static_cast<size_t>(vv) * B + b) * src_view);
      unsigned char* wb = smem + (st & 1) * kWindowBytes;
      // a row is win.w * kChunks chunks; the threads take rows in turn
      const int row = win.w * S::kChunks;
      const int rows = max(1, kTileThreads / row);  // rows per pass
      for (int i = tid % row + (tid / row) * row; i < rows * row; i += kTileThreads) {
        const int rx = i % row / S::kChunks, c = i % S::kChunks;
        const int x = win.x0 + rx;
        for (int ry = i / row; ry < win.h; ry += rows) {
          const int y = win.y0 + ry;
          unsigned char* dst = wb + 16 * ((ry * win.w + rx) * S::kStride + c);
          if (x >= 0 && x < W && y >= 0 && y < H)
            cp_async16(dst, sv + (static_cast<size_t>(y) * W + x) * (C * sizeof(T)) + 16 * c);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
    if (stats != nullptr && tid == 0) {
      atomicAdd(stats, 1);
      if (!win.staged) atomicAdd(stats + 1, 1);
    }
  };

  // The samples of step st (view v): each sample's 8 channels read from the
  // staged window or (kStaged false) from the source in device memory; in a
  // scatter step, w_k * row added at its taps in the accumulator window or
  // (kStaged false) in d srcs. Shared-memory float adds compile to
  // compare-and-swap loops on sm_90 (ATOMS.CAST.SPIN), so the staged scatter
  // saves them two ways. A warp is 32 neighbouring pixels of a tile row, whose
  // samples at one hypothesis mostly sit one source pixel apart: where the
  // right tap column of lane i is the left one of lane i+1 (equal window
  // indices), lane i+1 takes lane i's contributions there by a shuffle. And a
  // pixel's hypotheses move its taps by a fraction of a pixel each, so the
  // left column's sums stay in registers (tacc) while the tap set (its first
  // window pixel tq) stays, and go to the window when it changes; a right
  // column that no lane takes goes to the window at once (two more columns of
  // sums would not fit in 128 registers). Every lane of the warp runs this,
  // its own pixel or not (a pixel outside the image has no taps).
  auto sample = [&](auto staged, int st, const Window& win) {
    constexpr bool kStaged = decltype(staged)::value;
    const int v = st % Vs;
    const bool scatter = !kVar || st >= Vs;
    const float wt = kVar ? 0.f : wn[(static_cast<size_t>(b) * Vs + v) * hw + pix];
    const T* wb = reinterpret_cast<const T*>(smem + (st & 1) * kWindowBytes) + grp * 8;
    const T* sv = src + (static_cast<size_t>(v) * B + b) * src_view + grp * 8;
    float* dv = dsrc + (static_cast<size_t>(v) * B + b) * src_view + grp * 8;
    const unsigned acc_s = static_cast<unsigned>(__cvta_generic_to_shared(acc_win));
    constexpr int kPix = S::kStride * 16 / static_cast<int>(sizeof(T));  // elements per pixel
    const float xmax = static_cast<float>(W - 1), ymax = static_cast<float>(H - 1);
    const int lane = tid & 31;
    float dw = 0.f;
    float tacc[2][8];  // the sums at taps 0 and 2 of tq
    int tq = -1;
    // w * v[0..8) into the window at pixel q
    auto add_row = [&](int q, float w, const float* v) {
      const int rot = (q >> S::kRotShift) + grp * 8;
      const unsigned base = acc_s + static_cast<unsigned>(q) * C * 4;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        red_shared(base + static_cast<unsigned>((rot + c) & (C - 1)) * 4, __fmul_rn(w, v[c]));
    };
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      const int d = d0 + j;
      if (d < D) {
        const float2 uv = position(v, j);
        float xs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float wk[4];
        int q0 = 0;
        bool some;
        adamvs::TapGrid t;
        if constexpr (kStaged) {
          // all four taps from the window, those outside the image from its
          // ring of zeros; weights as common.cuh::bilinear_tap_grid
          const float u0 = floorf(uv.x), v0 = floorf(uv.y);
          some = u0 >= -1.f && u0 <= xmax && v0 >= -1.f && v0 <= ymax;
          const float du = __fsub_rn(uv.x, u0), dv_ = __fsub_rn(uv.y, v0);
          const float eu = __fsub_rn(1.f, du), ev = __fsub_rn(1.f, dv_);
          wk[0] = some ? __fmul_rn(eu, ev) : 0.f;
          wk[1] = some ? __fmul_rn(du, ev) : 0.f;
          wk[2] = some ? __fmul_rn(eu, dv_) : 0.f;
          wk[3] = some ? __fmul_rn(du, dv_) : 0.f;
          q0 = some ? (static_cast<int>(v0) - win.y0) * win.w + static_cast<int>(u0) - win.x0 : 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float vals[8];
            load8_shared(wb + (q0 + (k & 1) + (k >> 1) * win.w) * kPix, vals);
#pragma unroll
            for (int c = 0; c < 8; ++c) xs[c] = __fmaf_rn(vals[c], wk[k], xs[c]);
          }
        } else {
          t = adamvs::bilinear_tap_grid(H, W, uv.x, uv.y);
          some = t.ok[0] || t.ok[1] || t.ok[2] || t.ok[3];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            wk[k] = t.w[k];
            if (t.ok[k]) {
              float vals[8];
              Row<T, 8>::load(sv + (static_cast<size_t>(t.y0 + (k >> 1)) * W + t.x0 + (k & 1)) * C,
                              vals);
#pragma unroll
              for (int c = 0; c < 8; ++c) xs[c] = __fmaf_rn(vals[c], wk[k], xs[c]);
            }
          }
        }
        if (!scatter) {  // var, the mean pass: s += X_v, the views in order
          if constexpr (kVar) {
#pragma unroll
            for (int c = 0; c < 8; ++c) m[j][c] = __fadd_rn(m[j][c], xs[c]);
          }
          continue;
        }
        const T* gp = gout + ((static_cast<size_t>(d) * B + b) * C + grp * 8) * hw + pix;
        float row[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float gc = to_f32(gp[static_cast<size_t>(c) * hw]);
          if constexpr (kVar) {
            row[c] = __fmul_rn(__fmul_rn(k2, gc), __fsub_rn(xs[c], m[j][c]));
          } else {
            const float gr = __fmul_rn(gc, r[c]);
            dw = fmaf(gr, xs[c], dw);
            a[c] = fmaf(__fmul_rn(gc, wt), xs[c], a[c]);
            row[c] = __fmul_rn(gr, wt);
          }
        }
        if constexpr (kStaged) {
          // lane i+1 takes lane i's taps 1 and 3 where they are its taps 0 and 2
          const int qs = some ? q0 : -2;
          const int ql = __shfl_up_sync(0xffffffffu, qs, 1);
          const int qr = __shfl_down_sync(0xffffffffu, qs, 1);
          const bool take = some && lane > 0 && ql >= 0 && ql + 1 == q0;
          const bool give = some && lane < 31 && qr >= 0 && qr == q0 + 1;
          const float wl1 = __shfl_up_sync(0xffffffffu, wk[1], 1);
          const float wl3 = __shfl_up_sync(0xffffffffu, wk[3], 1);
          float rowl[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) rowl[c] = __shfl_up_sync(0xffffffffu, row[c], 1);
          if (some) {
            if (q0 != tq) {
              if (tq >= 0) {
                add_row(tq, 1.f, tacc[0]);
                add_row(tq + win.w, 1.f, tacc[1]);
              }
              tq = q0;
#pragma unroll
              for (int c = 0; c < 8; ++c) tacc[0][c] = tacc[1][c] = 0.f;
            }
            const float el1 = take ? wl1 : 0.f, el3 = take ? wl3 : 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              tacc[0][c] = __fmaf_rn(el1, rowl[c], __fmaf_rn(wk[0], row[c], tacc[0][c]));
              tacc[1][c] = __fmaf_rn(el3, rowl[c], __fmaf_rn(wk[2], row[c], tacc[1][c]));
            }
            if (!give) {
              add_row(q0 + 1, wk[1], row);
              add_row(q0 + win.w + 1, wk[3], row);
            }
          }
        } else if (some) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (t.ok[k]) {
              float vals[8];
#pragma unroll
              for (int c = 0; c < 8; ++c) vals[c] = __fmul_rn(wk[k], row[c]);
              atomic_add_row<8>(dv + (static_cast<size_t>(t.y0 + (k >> 1)) * W + t.x0 + (k & 1)) * C,
                                vals);
            }
          }
        }
      }
    }
    if (kStaged && tq >= 0) {
      add_row(tq, 1.f, tacc[0]);
      add_row(tq + win.w, 1.f, tacc[1]);
    }
    if (!kVar && own) atomicAdd(dwn + (static_cast<size_t>(b) * Vs + v) * hw + pix, dw);
  };

  // Each in-image pixel of view v's accumulator window added once to d srcs,
  // 4 channels per float4 atomic; the whole window (ring included) zeroed.
  auto flush = [&](int v, const Window& win) {
    float* dv = dsrc + (static_cast<size_t>(v) * B + b) * src_view;
    const int items = win.w * win.h * (C / 4);
    for (int i = tid; i < items; i += kTileThreads) {
      const int q = i / (C / 4), c4 = i % (C / 4) * 4;
      const int ry = q / win.w, rx = q - ry * win.w;
      float* at = acc_win + q * C;
      const int rot = q >> S::kRotShift;
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int slot = (c4 + k + rot) & (C - 1);
        e[k] = at[slot];
        at[slot] = 0.f;
      }
      const int x = win.x0 + rx, y = win.y0 + ry;
      if (x >= 0 && x < W && y >= 0 && y < H &&
          (e[0] != 0.f || e[1] != 0.f || e[2] != 0.f || e[3] != 0.f))
        atomicAdd(reinterpret_cast<float4*>(dv + (static_cast<size_t>(y) * W + x) * C + c4),
                  make_float4(e[0], e[1], e[2], e[3]));
    }
  };

  // Step st+1's positions, box and copies go out before step st is sampled
  // and are waited for after it; then step st's accumulator is flushed.
  prepare(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int st = 0; st < nsteps; ++st) {
    const Window cur = window_of(st);
    if (st + 1 < nsteps) prepare(st + 1);
    if (cur.w > 0) {  // a view with no tap in the image adds nothing
      if (cur.staged)
        sample(std::true_type{}, st, cur);
      else
        sample(std::false_type{}, st, cur);
    }
    if constexpr (kVar) {
      if (st == Vs - 1 && own) {  // the mean, and d ref = sum_d g (2/nv)(ref - m)
        float r0[8], a0[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        Row<T, 8>::load(ref_own, r0);
#pragma unroll
        for (int j = 0; j < KD; ++j) {
          const int d = d0 + j;
          if (d < D) {
            const T* gp = gout + ((static_cast<size_t>(d) * B + b) * C + grp * 8) * hw + pix;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              m[j][c] = __fdiv_rn(m[j][c], nv);
              a0[c] = fmaf(__fmul_rn(k2, to_f32(gp[static_cast<size_t>(c) * hw])),
                           __fsub_rn(r0[c], m[j][c]), a0[c]);
            }
          }
        }
        atomic_add_row<8>(dref + bp * C + grp * 8, a0);
      }
    }
    if (st + 1 < nsteps && tid == 0) {
      // every thread read step st's box before prepare(st+1); step st+2 takes it
      int* box = boxes + 4 * (st & 1);
      box[0] = INT_MAX, box[1] = INT_MAX, box[2] = INT_MIN, box[3] = INT_MIN;
    }
    cp_async_wait<0>();
    __syncthreads();  // step st+1's window in place, step st's accumulator complete
    if ((!kVar || st >= Vs) && cur.staged && cur.w > 0) {
      flush(st % Vs, cur);
      __syncthreads();  // the accumulator zeroed again
    }
  }
  if constexpr (!kVar) {
    if (own) atomic_add_row<8>(dref + bp * C + grp * 8, a);
  }
}

template <typename T, int C>
int launch_corr(int Vs, int B, int h, int w, int H, int W, int D, const void* g, const void* ref,
                const void* src, const void* geom, const void* lo, const void* step, void* dref,
                void* dsrc, void* stats, cudaStream_t s) {
  const dim3 grid((h * w + kWalkThreads - 1) / kWalkThreads, Vs * B, (D + kRun - 1) / kRun);
  corr_walk_bwd_kernel<T, C><<<grid, kWalkThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(geom), static_cast<const float*>(lo),
      static_cast<const float*>(step), static_cast<float*>(dref), static_cast<float*>(dsrc),
      static_cast<int*>(stats), B, h, w, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, bool kVar>
int launch_tile(int Vs, int B, int h, int w, int H, int W, int D, const void* g, const void* ref,
                const void* src, const void* geom, const void* lo, const void* step,
                const void* wn, void* dref, void* dwn, void* dsrc, void* stats, cudaStream_t s) {
  using S = BwdTile<T, C, kVar>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      sweep_bwd_tile_kernel<T, C, kVar>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((D + S::kD - 1) / S::kD, (w + kTileW - 1) / kTileW,
                  B * ((h + S::kRows - 1) / S::kRows));
  sweep_bwd_tile_kernel<T, C, kVar><<<grid, kTileThreads, S::kSmemBytes, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(geom), static_cast<const float*>(lo),
      static_cast<const float*>(step), static_cast<const float*>(wn), static_cast<float*>(dref),
      static_cast<float*>(dwn), static_cast<float*>(dsrc), static_cast<int*>(stats), Vs, B, h, w,
      H, W, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int corr_for_channels(int C, int Vs, int B, int h, int w, int H, int W, int D, const void* g,
                      const void* ref, const void* src, const void* geom, const void* lo,
                      const void* step, void* dref, void* dsrc, void* stats, cudaStream_t s) {
  switch (C) {
    case 8:
      return launch_corr<T, 8>(Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, dref, dsrc,
                               stats, s);
    case 16:
      return launch_corr<T, 16>(Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, dref, dsrc,
                                stats, s);
    case 32:
      return launch_corr<T, 32>(Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, dref, dsrc,
                                stats, s);
    default: return adamvs::kBadChannels;
  }
}

template <typename T, bool kVar>
int tile_for_channels(int C, int Vs, int B, int h, int w, int H, int W, int D, const void* g,
                      const void* ref, const void* src, const void* geom, const void* lo,
                      const void* step, const void* wn, void* dref, void* dwn, void* dsrc,
                      void* stats, cudaStream_t s) {
  switch (C) {
    case 8:
      return launch_tile<T, 8, kVar>(Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, wn, dref,
                                     dwn, dsrc, stats, s);
    case 16:
      return launch_tile<T, 16, kVar>(Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, wn, dref,
                                      dwn, dsrc, stats, s);
    case 32:
      return launch_tile<T, 32, kVar>(Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, wn, dref,
                                      dwn, dsrc, stats, s);
    default: return adamvs::kBadChannels;
  }
}

template <bool kVar>
int tile_for_dtype(int dtype, int Vs, int B, int h, int w, int H, int W, int C, int D,
                   const void* g, const void* ref, const void* src, const void* geom,
                   const void* lo, const void* step, const void* wn, void* dref, void* dwn,
                   void* dsrc, void* stats, void* stream) {
  if (Vs > kMaxViews) return adamvs::kBadViews;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32)
    return tile_for_channels<float, kVar>(C, Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step,
                                          wn, dref, dwn, dsrc, stats, s);
  if (dtype == adamvs::kBFloat16)
    return tile_for_channels<__nv_bfloat16, kVar>(C, Vs, B, h, w, H, W, D, g, ref, src, geom, lo,
                                                  step, wn, dref, dwn, dsrc, stats, s);
  return adamvs::kBadDtype;
}

}  // namespace

// K5, corr. dref and dsrc must be zeroed float32; `stats` may be null: when
// it is not, the kernel adds the samples it walked to stats[0] and its
// flushes to stats[1]. Returns 0 or the launch error.
extern "C" int adamvs_corr_sweep_bwd(int dtype, int Vs, int B, int h, int w, int H, int W, int C,
                                     int D, const void* g, const void* ref, const void* src,
                                     const void* geom, const void* lo, const void* step,
                                     void* dref, void* dsrc, void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32)
    return corr_for_channels<float>(C, Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, dref,
                                    dsrc, stats, s);
  if (dtype == adamvs::kBFloat16)
    return corr_for_channels<__nv_bfloat16>(C, Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step,
                                            dref, dsrc, stats, s);
  return adamvs::kBadDtype;
}

// K5, fused. dref, dwn and dsrc must be zeroed float32; `stats` may be null.
// Returns 0 or the launch error.
extern "C" int adamvs_fused_sweep_bwd(int dtype, int Vs, int B, int h, int w, int H, int W, int C,
                                      int D, const void* g, const void* ref, const void* src,
                                      const void* geom, const void* lo, const void* step,
                                      const void* wn, void* dref, void* dwn, void* dsrc,
                                      void* stats, void* stream) {
  return tile_for_dtype<false>(dtype, Vs, B, h, w, H, W, C, D, g, ref, src, geom, lo, step, wn,
                               dref, dwn, dsrc, stats, stream);
}

// K5, var. dref and dsrc must be zeroed float32; `stats` may be null. Returns
// 0 or the launch error.
extern "C" int adamvs_var_sweep_bwd(int dtype, int Vs, int B, int h, int w, int H, int W, int C,
                                    int D, const void* g, const void* ref, const void* src,
                                    const void* geom, const void* lo, const void* step, void* dref,
                                    void* dsrc, void* stats, void* stream) {
  return tile_for_dtype<true>(dtype, Vs, B, h, w, H, W, C, D, g, ref, src, geom, lo, step,
                              nullptr, dref, nullptr, dsrc, stats, stream);
}
