// Plane-sweep volumes: kernels K1 (corr), K2 (fused) and K4 (var).
//
// Replaces the Pallas kernel adamvs_tpu/ops/sweep_fuse.py::_sweep_kernel
// (:188) in its three inference modes:
//   K1 corr_sweep_volume (:611, pallas_call :679): per source view v and
//      hypothesis d, mean_C(ref * bilinear_v(hyp_d)), hyp_d = lo + d*step;
//      exact form _xla_corr_volume (:763).
//   K2 fused_sweep_volume (:418, pallas_call :483):
//      sum_v w'_v (ref * bilinear_v(hyp_d)) with w' = w / (1e-5 + sum w)
//      normalised by the caller; exact form _xla_fused_volume (:725).
//   K4 var_sweep_volume (:515, pallas_call :571): the variance
//      E[x^2] - E[x]^2 over {ref, bilinear_1(hyp_d) .. bilinear_Vs(hyp_d)},
//      nv = Vs + 1; exact form _xla_var_volume (:743).
// The TPU kernel's merged-lane band DMA, band origins and S-matrix combine
// are TPU artefacts and are not copied: every in-image tap is read, where the
// TPU kernel zeroes samples that leave its band.
//
// K1: one thread per (view, batch, reference pixel, chunk of 8 hypotheses),
// 128-thread blocks along the flattened pixel index. The thread keeps the
// reference features in registers and gathers each sample's four taps as
// 16-byte vector loads straight from the NHWC source (common.cuh::
// gather_taps). Its bound on an H100 is the tap arithmetic (operations).
//
// K2 and K4: what bounds them. Each sample reads four taps of a C-channel
// source row, about 47 GB of taps per bf16 depth map over the three stages,
// against ~4 GB of device memory that the function must move (each source
// read once, each volume written once; the bound is K2 1.14 ms by bytes, K4
// 1.23 ms by operations per map). PR 1-2's kernels gathered the taps through
// L1/L2 at 10-11x the bound. Moving the taps to shared memory showed that the
// gathers were not what held them back. On an H100 80GB HBM3 at 700 W
// (chip_smoke.py --ablate, ms per map) K2 takes 7.34 as built, 5.23 with its
// sampling left out, 7.05 with trivial positions, 7.34 without stores and
// 1.23 with an empty kernel (the wrapper's own work); K4 10.35, 8.46, 10.03,
// 9.39 and 0.91. The tap arithmetic (a fused multiply-add and a bf16 unpack
// per channel and tap) is ~2 ms of each; most of the rest is the chain of
// each (tile, chunk, view): positions, a barrier, the window copy, a barrier.
// The design:
//   - A block owns a 2-D tile of reference pixels, 32 wide and 256/(C/8)
//     pixels in all, for one batch and a chunk of kD hypotheses (8 for K2, 4
//     for K4, whose s and sq take twice the registers; 64 accumulators each
//     at 128 registers, two 256-thread blocks per SM). Each thread takes one
//     pixel and 8 channels (C/8 lanes per pixel, channel group major), so a
//     warp is 32 neighbouring pixels of one tile row and each channel plane's
//     stores are coalesced. The chunks of a tile are neighbouring blocks, so
//     they find the tile's source footprint in L2.
//   - Per source view the block computes every sample's source position (the
//     plain version's rounding order, as common.cuh::sweep_taps) into shared
//     memory, reduces the box of all in-image taps (samples behind the
//     camera and taps outside the image do not widen it), and copies the box
//     with a ring of one pixel into shared memory with cp.async 16-byte
//     copies; the ring is zero outside the image. A staged pixel takes an
//     odd number of 16-byte slots, so the 8 lanes of a quarter warp, reading
//     one slot of 8 neighbouring pixels, hit 8 different bank groups; a bulk
//     copy (cp.async.bulk) would keep NHWC rows, whose pixels lie C*2 or C*4
//     bytes apart, and such reads conflict 2- to 8-way.
//   - The windows are double-buffered: view v+1's positions, box and copies
//     are issued before view v is sampled, and waited for after.
//   - A sample with some tap in the image reads all four taps from the window
//     with no masks (a tap outside the image reads the ring's zeros, as the
//     plain version adds it with weight 0); one with none adds nothing. The
//     taps and weights are common.cuh::bilinear_tap_grid's. A window larger
//     than kWindowBytes (a depth edge or a steep view spreads the taps) is
//     not staged: that view's samples gather their in-image taps from the
//     source in device memory, the same taps in the same order.
//   - Sums stay float32, views in order, taps in order, as fused
//     multiply-adds (float32 agreement with the plain versions ~1e-7); K2
//     sums w'_v * sample_v and multiplies by ref once; K4 starts s and sq
//     from ref.
// Shared memory per block: two windows of kWindowBytes, two position buffers
// (kD x pixels float2), lo/step and K2's weights of the tile, the geometry.
// What would help next: fewer, longer-lived blocks that run the chain of the
// next (tile, chunk, view) while sampling this one.
//
// Layouts: ref [B,h,w,C], src [Vs,B,H,W,C] (float32 or bfloat16), geom
// [Vs*B,12] float32 (rot row-major, then trans), lo/step [B,h,w] float32,
// wn [B,Vs,h,w] float32. K1 writes float32 [Vs,B,D,h,w]; K2 and K4 write the
// feature dtype as [D,B,C,h,w], the layout the regularisers read one depth
// slice [B,C,h,w] at a time. K2 and K4 take an optional int[2] `stats`: when
// it is not null, each block adds, per source view, 1 to stats[0] and, if the
// view's window was gathered directly, 1 to stats[1].

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using adamvs::Row;
using adamvs::store;

constexpr int kThreads = 128;
constexpr int kDChunk = 8;
constexpr int kMaxViews = 16;

// Bilinear sample (zeros padding) of src [H,W,C] at the source position of
// reference pixel (x, y) at depth hyp (common.cuh::sweep_taps).
template <typename T, int C>
__device__ __forceinline__ void warp_sample(const T* __restrict__ src, int H, int W,
                                            const float* g, float x, float y, float hyp,
                                            float* out) {
  adamvs::gather_taps<T, C>(src, adamvs::sweep_taps(g, x, y, hyp, H, W), out);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
corr_kernel(const T* __restrict__ ref, const T* __restrict__ src, const float* __restrict__ geom,
            const float* __restrict__ lo, const float* __restrict__ step, float* __restrict__ out,
            int B, int h, int w, int H, int W, int D) {
  const int hw = h * w;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const int vb = blockIdx.y;  // v * B + b
  const int b = vb % B;
  __shared__ float g[12];
  if (threadIdx.x < 12) g[threadIdx.x] = geom[vb * 12 + threadIdx.x];
  __syncthreads();
  if (pix >= hw) return;
  const float x = static_cast<float>(pix % w), y = static_cast<float>(pix / w);
  const size_t bp = static_cast<size_t>(b) * hw + pix;
  float r[C];
  Row<T, C>::load(ref + bp * C, r);
  const float l = lo[bp], st = step[bp];
  const T* s = src + static_cast<size_t>(vb) * H * W * C;
  const int d0 = blockIdx.z * kDChunk;
  const int d1 = min(D, d0 + kDChunk);
  float wv[C];
  for (int d = d0; d < d1; ++d) {
    const float hyp = __fadd_rn(l, __fmul_rn(static_cast<float>(d), st));
    warp_sample<T, C>(s, H, W, g, x, y, hyp, wv);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc = fmaf(r[c], wv[c], acc);
    out[(static_cast<size_t>(vb) * D + d) * hw + pix] = acc / static_cast<float>(C);
  }
}

// --- K2 and K4: 2-D tiles over source windows in shared memory ---------------

constexpr int kTileThreads = 256;
constexpr int kTileW = 32;
constexpr int kWindowBytes = 36 * 1024;  // one staged source window

// The shape of a K2 (kVar false) or K4 (kVar true) block and its shared memory.
template <typename T, int C, bool kVar>
struct Tile {
  static constexpr int kLanes = C / 8;                  // threads per pixel, 8 channels each
  static constexpr int kPixels = kTileThreads / kLanes;  // pixels per tile
  static constexpr int kRows = kPixels / kTileW;
  static constexpr int kD = kVar ? 4 : 8;                // hypotheses per block
  static constexpr int kChunks = C * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per pixel
  // A staged pixel holds its C channels in an odd number of 16-byte slots,
  // so that one slot of 8 neighbouring pixels (a quarter warp's 16-byte
  // loads) lies in 8 different groups of 4 banks.
  static constexpr int kStride = kChunks | 1;
  static constexpr int kSamples = kD * kPixels;          // samples per source view
  static constexpr size_t kCoordOffset = 2 * static_cast<size_t>(kWindowBytes);
  static constexpr size_t kLoOffset = kCoordOffset + 2 * kSamples * 2 * sizeof(float);
  static constexpr size_t kWnOffset = kLoOffset + 2 * kPixels * sizeof(float);
  static constexpr size_t kGeomOffset = kWnOffset + 2 * kPixels * sizeof(float);
  static constexpr size_t kBoxOffset = kGeomOffset + kMaxViews * 12 * sizeof(float);
  static constexpr size_t kSmemBytes = kBoxOffset + 8 * sizeof(int);
  static_assert(kPixels % kTileW == 0, "a tile is whole rows of 32 pixels");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 channels at p (16 bytes of bf16 or 32 of float32, in shared memory), as
// float32.
__device__ __forceinline__ void load8_shared(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(words[j] << 16);
    v[2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8_shared(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = c.x, v[5] = c.y, v[6] = c.z, v[7] = c.w;
}

// One view's source window: the box [x0, x0+w) x [y0, y0+h) of the source,
// staged in shared memory or (staged false) read from device memory.
struct Window {
  int x0, y0, w, h;
  bool staged;
};

template <typename T, int C, bool kVar>
__global__ void __launch_bounds__(kTileThreads, 2)
sweep_tile_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                  const float* __restrict__ geom, const float* __restrict__ lo,
                  const float* __restrict__ step, const float* __restrict__ wn,
                  T* __restrict__ out, int* __restrict__ stats, int Vs, int B, int h, int w,
                  int H, int W, int D) {
  using S = Tile<T, C, kVar>;
  constexpr int P = S::kPixels, KD = S::kD;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* coords = reinterpret_cast<float2*>(smem + S::kCoordOffset);  // [2][KD*P]
  float* lo_s = reinterpret_cast<float*>(smem + S::kLoOffset);         // [P]
  float* st_s = lo_s + P;                                              // [P]
  float* wn_s = reinterpret_cast<float*>(smem + S::kWnOffset);         // K2: [2][P]
  float* g = reinterpret_cast<float*>(smem + S::kGeomOffset);          // [Vs*12]
  int* boxes = reinterpret_cast<int*>(smem + S::kBoxOffset);           // [2][4]

  const int tid = threadIdx.x;
  const int p = tid % P, grp = tid / P;
  // the hypothesis chunks of a tile are neighbouring blocks, so that they read
  // the tile's source footprint from L2
  const int ntile_y = (h + S::kRows - 1) / S::kRows;
  const int b = blockIdx.z / ntile_y;
  const int d0 = blockIdx.x * KD;
  const int tx0 = blockIdx.y * kTileW, ty0 = (blockIdx.z % ntile_y) * S::kRows;
  const int hw = h * w;
  for (int i = tid; i < Vs * 12; i += kTileThreads) g[i] = geom[((i / 12) * B + b) * 12 + i % 12];
  for (int i = tid; i < P; i += kTileThreads) {
    const int x = tx0 + i % kTileW, y = ty0 + i / kTileW;
    const bool in = x < w && y < h;
    const size_t at = static_cast<size_t>(b) * hw + static_cast<size_t>(y) * w + x;
    lo_s[i] = in ? lo[at] : 0.f;
    st_s[i] = in ? step[at] : 0.f;
  }
  if (tid < 8) boxes[tid] = tid % 4 < 2 ? INT_MAX : INT_MIN;  // views 0 and 1: empty
  const int px = tx0 + p % kTileW, py = ty0 + p / kTileW;
  const bool own = px < w && py < h;
  const size_t pix = static_cast<size_t>(py) * w + px;
  const size_t src_view = static_cast<size_t>(H) * W * C;

  // this thread's 8 reference channels
  const T* ref_own = ref + (static_cast<size_t>(b) * hw + pix) * C + grp * 8;
  // K2: acc = sum_v w'_v * sample_v from 0, times ref at the end; K4: acc = s
  // from ref, acc2 = sq from ref^2
  float acc[KD][8], acc2[kVar ? KD : 1][8];
  {
    float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (kVar && own) Row<T, 8>::load(ref_own, r);
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if constexpr (kVar) {
          acc[j][c] = r[c];
          acc2[j][c] = __fmul_rn(r[c], r[c]);
        } else {
          acc[j][c] = 0.f;
        }
      }
  }
  __syncthreads();  // g, lo_s, st_s, boxes

  // View vv's window from its box in shared memory (final once prepare(vv)
  // passed its barrier). The staged window is the box with a ring of one
  // pixel: a tap outside the image next to one inside lies on the ring,
  // which holds zeros there.
  auto window_of = [&](int vv) -> Window {
    const int* box = boxes + 4 * (vv & 1);
    Window win{box[0] - 1, box[1] - 1, 0, 0, true};
    if (box[2] >= box[0]) {  // some tap lies in the image
      win.w = box[2] - box[0] + 3;
      win.h = box[3] - box[1] + 3;
      win.staged = static_cast<long long>(win.w) * win.h * S::kStride * 16 <= kWindowBytes;
    }
    return win;
  };

  // Positions, box and copies of view vv's window (buffers vv & 1).
  auto prepare = [&](int vv) {
    int* box = boxes + 4 * (vv & 1);
    float2* cv = coords + (vv & 1) * S::kSamples;
    const float* gv = g + 12 * vv;
    // A thread places the samples tid + 256k: always the pixel q = tid % P, at
    // the hypotheses d0 + tid / P + k * (256 / P). The taps of a sample at
    // (u, v) are {u0, u0+1} x {v0, v0+1} (the floors) cut to the image; some
    // count exactly when -1 <= u < W and -1 <= v < H, and the box of all of
    // them is [max(floor(min u), 0), min(floor(max u) + 1, W-1)] x (the same
    // in v), over the samples that have some.
    const int q = tid % P, x = tx0 + q % kTileW, y = ty0 + q / kTileW;
    const bool in = x < w && y < h;
    float rxyz[3];  // rot.[x,y,1], in the order of common.cuh::sweep_taps
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rxyz[i] = __fadd_rn(__fadd_rn(__fmul_rn(gv[3 * i], static_cast<float>(x)),
                                    __fmul_rn(gv[3 * i + 1], static_cast<float>(y))),
                          gv[3 * i + 2]);
    const float lq = lo_s[q], sq = st_s[q], fw = static_cast<float>(W), fh = static_cast<float>(H);
    float umin = 3e38f, vmin = 3e38f, umax = -3e38f, vmax = -3e38f;
    int d = d0 + tid / P;
#pragma unroll 2
    for (int k = 0; k < S::kSamples / kTileThreads; ++k, d += kTileThreads / P) {
      float u = -1e9f, v = -1e9f;  // no tap, as the plain version's behind-camera samples
      if (in && d < D) {
        const float hyp = __fadd_rn(lq, __fmul_rn(static_cast<float>(d), sq));
        const float pz = __fadd_rn(__fmul_rn(rxyz[2], hyp), gv[11]);
        if (pz > 1e-6f) {
          u = __fdiv_rn(__fadd_rn(__fmul_rn(rxyz[0], hyp), gv[9]), pz);
          v = __fdiv_rn(__fadd_rn(__fmul_rn(rxyz[1], hyp), gv[10]), pz);
          if (u >= -1.f && u < fw && v >= -1.f && v < fh) {
            umin = fminf(umin, u), umax = fmaxf(umax, u);
            vmin = fminf(vmin, v), vmax = fmaxf(vmax, v);
          }
        }
      }
      cv[tid + k * kTileThreads] = make_float2(u, v);
    }
    // empty: x0 > x1 (INT_MAX / INT_MIN); else exact small integers
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
    const Window win = window_of(vv);
    if (win.staged && win.w > 0) {
      const unsigned char* sv = reinterpret_cast<const unsigned char*>(
          src + (static_cast<size_t>(vv) * B + b) * src_view);
      unsigned char* wb = smem + (vv & 1) * kWindowBytes;
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
    if constexpr (!kVar) {  // K2: the tile's visibility weights of view vv
      if (in) {
        const float* src_w = wn + (static_cast<size_t>(b) * Vs + vv) * hw + static_cast<size_t>(y) * w + x;
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(wn_s + (vv & 1) * P + q));
        if (tid < P)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src_w) : "memory");
      }
    }
    cp_async_commit();
    if (stats != nullptr && tid == 0) {
      atomicAdd(stats, 1);
      if (!win.staged) atomicAdd(stats + 1, 1);
    }
  };

  // The samples of view v, their taps read from the staged window or
  // (kStaged false) from the source in device memory.
  auto sample = [&](auto staged, int v, const Window& win) {
    const float wt = kVar ? 0.f : wn_s[(v & 1) * P + p];
    constexpr bool kStaged = decltype(staged)::value;
    const float2* cv = coords + (v & 1) * S::kSamples;
    const T* wb = reinterpret_cast<const T*>(smem + (v & 1) * kWindowBytes) + grp * 8;
    const T* sv = src + (static_cast<size_t>(v) * B + b) * src_view + grp * 8;
    constexpr int kPix = S::kStride * 16 / static_cast<int>(sizeof(T));  // elements per pixel
    const float xmax = static_cast<float>(W - 1), ymax = static_cast<float>(H - 1);
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      // K2's 64 accumulators leave no registers for the next hypothesis's
      // loads, which the compiler would otherwise hoist (and spill)
      if constexpr (!kVar) {
        if (j > 0) __syncwarp(__activemask());
      }
      const float2 uv = cv[j * P + p];
      float wv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if constexpr (kStaged) {
        // The four taps are read from the window, those outside the image from
        // its ring of zeros, as the plain version adds them with weight 0. A
        // sample with no tap in the image reads the window's corner with
        // weight 0. Weights as common.cuh::bilinear_tap_grid computes them.
        const float u0 = floorf(uv.x), v0 = floorf(uv.y);
        const bool some = u0 >= -1.f && u0 <= xmax && v0 >= -1.f && v0 <= ymax;
        const float du = __fsub_rn(uv.x, u0), dv = __fsub_rn(uv.y, v0);
        const float eu = __fsub_rn(1.f, du), ev = __fsub_rn(1.f, dv);
        const float wk[4] = {some ? __fmul_rn(eu, ev) : 0.f, some ? __fmul_rn(du, ev) : 0.f,
                             some ? __fmul_rn(eu, dv) : 0.f, some ? __fmul_rn(du, dv) : 0.f};
        const int q0 = some ? (static_cast<int>(v0) - win.y0) * win.w + static_cast<int>(u0) - win.x0
                            : 0;
        const T* a0 = wb + q0 * kPix;
        const T* at[4] = {a0, a0 + kPix, a0 + win.w * kPix, a0 + (win.w + 1) * kPix};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float vals[8];
          load8_shared(at[k], vals);
#pragma unroll
          for (int c = 0; c < 8; ++c) wv[c] = __fmaf_rn(vals[c], wk[k], wv[c]);
        }
      } else {
        const adamvs::TapGrid t = adamvs::bilinear_tap_grid(H, W, uv.x, uv.y);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t.ok[k]) {
            float vals[8];
            Row<T, 8>::load(sv + (static_cast<size_t>(t.y0 + (k >> 1)) * W + t.x0 + (k & 1)) * C,
                            vals);
#pragma unroll
            for (int c = 0; c < 8; ++c) wv[c] = __fmaf_rn(vals[c], t.w[k], wv[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if constexpr (kVar) {
          acc[j][c] = __fadd_rn(acc[j][c], wv[c]);
          acc2[j][c] = __fmaf_rn(wv[c], wv[c], acc2[j][c]);
        } else {
          acc[j][c] = __fmaf_rn(wt, wv[c], acc[j][c]);
        }
      }
    }
  };

  // View v+1's positions, box and copies go out before view v is sampled and
  // are waited for after it.
  prepare(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int v = 0; v < Vs; ++v) {
    const Window cur = window_of(v);
    if (v + 1 < Vs) prepare(v + 1);
    if (own && cur.w > 0) {  // a view with no tap in the image adds zeros
      if (cur.staged)
        sample(std::true_type{}, v, cur);
      else
        sample(std::false_type{}, v, cur);
    }
    if (v + 1 < Vs) {
      if (tid == 0) {  // every thread read view v's box before prepare(v+1); view v+2 takes it
        int* box = boxes + 4 * (v & 1);
        box[0] = INT_MAX, box[1] = INT_MAX, box[2] = INT_MIN, box[3] = INT_MIN;
      }
      cp_async_wait<0>();
      __syncthreads();  // view v+1's window and positions are in place, view v's buffers free
    }
  }
  if (!own) return;
  const float nv = static_cast<float>(Vs + 1);
  float r[8];
  if constexpr (!kVar) Row<T, 8>::load(ref_own, r);
#pragma unroll
  for (int j = 0; j < KD; ++j) {
    const int d = d0 + j;
    if (d >= D) break;
    T* o = out + ((static_cast<size_t>(d) * B + b) * C + grp * 8) * hw + pix;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if constexpr (kVar) {
        const float m = __fdiv_rn(acc[j][c], nv);
        store(o + static_cast<size_t>(c) * hw, __fsub_rn(__fdiv_rn(acc2[j][c], nv), __fmul_rn(m, m)));
      } else {
        store(o + static_cast<size_t>(c) * hw, __fmul_rn(r[c], acc[j][c]));
      }
    }
  }
}

template <typename T, int C>
int launch_corr(int Vs, int B, int h, int w, int H, int W, int D, const void* ref, const void* src,
                const void* geom, const void* lo, const void* step, void* out, cudaStream_t s) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, Vs * B, (D + kDChunk - 1) / kDChunk);
  corr_kernel<T, C><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src), static_cast<const float*>(geom),
      static_cast<const float*>(lo), static_cast<const float*>(step), static_cast<float*>(out), B, h,
      w, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, bool kVar>
int launch_tile(int Vs, int B, int h, int w, int H, int W, int D, const void* ref, const void* src,
                const void* geom, const void* lo, const void* step, const void* wn, void* out,
                void* stats, cudaStream_t s) {
  using S = Tile<T, C, kVar>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      sweep_tile_kernel<T, C, kVar>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((D + S::kD - 1) / S::kD, (w + kTileW - 1) / kTileW,
                  B * ((h + S::kRows - 1) / S::kRows));
  sweep_tile_kernel<T, C, kVar><<<grid, kTileThreads, S::kSmemBytes, s>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src), static_cast<const float*>(geom),
      static_cast<const float*>(lo), static_cast<const float*>(step), static_cast<const float*>(wn),
      static_cast<T*>(out), static_cast<int*>(stats), Vs, B, h, w, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVar>
int tile_for_channels(int C, int Vs, int B, int h, int w, int H, int W, int D, const void* ref,
                      const void* src, const void* geom, const void* lo, const void* step,
                      const void* wn, void* out, void* stats, cudaStream_t s) {
  switch (C) {
    case 8:
      return launch_tile<T, 8, kVar>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, wn, out,
                                     stats, s);
    case 16:
      return launch_tile<T, 16, kVar>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, wn, out,
                                      stats, s);
    case 32:
      return launch_tile<T, 32, kVar>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, wn, out,
                                      stats, s);
    default: return adamvs::kBadChannels;
  }
}

template <bool kVar>
int tile_for_dtype(int dtype, int Vs, int B, int h, int w, int H, int W, int C, int D,
                   const void* ref, const void* src, const void* geom, const void* lo,
                   const void* step, const void* wn, void* out, void* stats, void* stream) {
  if (Vs > kMaxViews) return adamvs::kBadViews;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32)
    return tile_for_channels<float, kVar>(C, Vs, B, h, w, H, W, D, ref, src, geom, lo, step, wn,
                                          out, stats, s);
  if (dtype == adamvs::kBFloat16)
    return tile_for_channels<__nv_bfloat16, kVar>(C, Vs, B, h, w, H, W, D, ref, src, geom, lo,
                                                  step, wn, out, stats, s);
  return adamvs::kBadDtype;
}

template <typename T>
int corr_for_channels(int C, int Vs, int B, int h, int w, int H, int W, int D, const void* ref,
                      const void* src, const void* geom, const void* lo, const void* step,
                      void* out, cudaStream_t s) {
  switch (C) {
    case 8: return launch_corr<T, 8>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out, s);
    case 16: return launch_corr<T, 16>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out, s);
    case 32: return launch_corr<T, 32>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out, s);
    default: return adamvs::kBadChannels;
  }
}

}  // namespace

// K1. Returns 0 or the launch error.
extern "C" int adamvs_corr_sweep(int dtype, int Vs, int B, int h, int w, int H, int W, int C, int D,
                                 const void* ref, const void* src, const void* geom,
                                 const void* lo, const void* step, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32)
    return corr_for_channels<float>(C, Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out, s);
  if (dtype == adamvs::kBFloat16)
    return corr_for_channels<__nv_bfloat16>(C, Vs, B, h, w, H, W, D, ref, src, geom, lo, step,
                                            out, s);
  return adamvs::kBadDtype;
}

// K2. `stats` may be null. Returns 0 or the launch error.
extern "C" int adamvs_fused_sweep(int dtype, int Vs, int B, int h, int w, int H, int W, int C,
                                  int D, const void* ref, const void* src, const void* geom,
                                  const void* lo, const void* step, const void* wn, void* out,
                                  void* stats, void* stream) {
  return tile_for_dtype<false>(dtype, Vs, B, h, w, H, W, C, D, ref, src, geom, lo, step, wn, out,
                               stats, stream);
}

// K4. `stats` may be null. Returns 0 or the launch error.
extern "C" int adamvs_var_sweep(int dtype, int Vs, int B, int h, int w, int H, int W, int C, int D,
                                const void* ref, const void* src, const void* geom, const void* lo,
                                const void* step, void* out, void* stats, void* stream) {
  return tile_for_dtype<true>(dtype, Vs, B, h, w, H, W, C, D, ref, src, geom, lo, step, nullptr,
                              out, stats, stream);
}
