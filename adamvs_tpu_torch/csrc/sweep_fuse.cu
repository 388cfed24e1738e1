// Plane-sweep volumes by direct gather: kernels K1 (corr), K2 (fused) and K4
// (var).
//
// Replaces the Pallas kernel adamvs_tpu/ops/sweep_fuse.py::_sweep_kernel in
// its three inference modes:
//   K1 corr_sweep_volume (:611, pallas_call :679): per source view v and
//      hypothesis d, mean_C(ref * bilinear_v(hyp_d)), hyp_d = lo + d*step;
//      exact form _xla_corr_volume (:763).
//   K2 fused_sweep_volume (:418, pallas_call :483):
//      sum_v w'_v (ref * bilinear_v(hyp_d)) with w' = w / (1e-5 + sum w)
//      normalised by the caller; exact form _xla_fused_volume (:725).
//   K4 var_sweep_volume (:515, pallas_call :571): the variance
//      E[x^2] - E[x]^2 over {ref, bilinear_1(hyp_d) .. bilinear_Vs(hyp_d)},
//      nv = Vs + 1; exact form _xla_var_volume (:743).
//
// What bounds it on an H100: the arithmetic of the bilinear taps (at least 8
// float32 operations per channel and sample, four length-C dot products or
// multiply-adds, at 67 TFLOP/s outside the tensor cores; these kernels do 10
// for K1 and 11 for K2 and K4) and, at the full-resolution stage, the output
// bytes (K2 and K4 write a C-channel volume per hypothesis). The source
// features are read from L2 mostly: neighbouring reference pixels sample
// neighbouring source pixels.
//
// Design: one thread per (batch, reference pixel, chunk of 8 hypotheses).
// The thread keeps the reference features in registers, computes each
// sample's coordinates from the 3x4 ref->src transform (rot, trans) and
// reads the four taps as 16-byte vector loads from NHWC source features
// (C contiguous; the gather is common.cuh::bilinear_taps, shared with the
// bilinear sampler). Everything accumulates in float32: K4 keeps s and sq
// per channel in registers, starting from ref and adding the views in order.
// The TPU kernel's merged-lane band DMA, band origins and S-matrix combine
// are TPU artefacts and are not copied: the gather here is exact for every
// in-image sample, where the TPU kernel zeroes samples that leave its band.
//
// Coordinates are computed with round-to-nearest intrinsics in the same
// operation order as the plain PyTorch version (ops/warp.py), so the two
// sample the same positions bit for bit.
//
// Layouts: ref [B,h,w,C], src [Vs,B,H,W,C] (float32 or bfloat16), geom
// [Vs*B,12] float32 (rot row-major, then trans), lo/step [B,h,w] float32,
// wn [B,Vs,h,w] float32. K1 writes float32 [Vs,B,D,h,w]; K2 and K4 write the
// feature dtype as [D,B,C,h,w], the layout the regularisers read one depth
// slice [B,C,h,w] at a time.

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

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const T* __restrict__ ref, const T* __restrict__ src, const float* __restrict__ geom,
             const float* __restrict__ lo, const float* __restrict__ step,
             const float* __restrict__ wn, T* __restrict__ out, int Vs, int B, int h, int w, int H,
             int W, int D) {
  const int hw = h * w;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  __shared__ float g[kMaxViews * 12];
  for (int i = threadIdx.x; i < Vs * 12; i += kThreads) g[i] = geom[((i / 12) * B + b) * 12 + i % 12];
  __syncthreads();
  if (pix >= hw) return;
  const float x = static_cast<float>(pix % w), y = static_cast<float>(pix / w);
  const size_t bp = static_cast<size_t>(b) * hw + pix;
  float r[C];
  Row<T, C>::load(ref + bp * C, r);
  const float l = lo[bp], st = step[bp];
  const size_t src_view = static_cast<size_t>(H) * W * C;
  const int d0 = blockIdx.z * kDChunk;
  const int d1 = min(D, d0 + kDChunk);
  float wv[C], acc[C];
  for (int d = d0; d < d1; ++d) {
    const float hyp = __fadd_rn(l, __fmul_rn(static_cast<float>(d), st));
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for (int v = 0; v < Vs; ++v) {
      const float wt = wn[(static_cast<size_t>(b) * Vs + v) * hw + pix];
      warp_sample<T, C>(src + (static_cast<size_t>(v) * B + b) * src_view, H, W, g + 12 * v, x, y,
                        hyp, wv);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(__fmul_rn(r[c], wv[c]), wt));
    }
    T* o = out + (static_cast<size_t>(d) * B + b) * C * hw + pix;
#pragma unroll
    for (int c = 0; c < C; ++c) store(o + static_cast<size_t>(c) * hw, acc[c]);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
var_kernel(const T* __restrict__ ref, const T* __restrict__ src, const float* __restrict__ geom,
           const float* __restrict__ lo, const float* __restrict__ step, T* __restrict__ out,
           int Vs, int B, int h, int w, int H, int W, int D) {
  const int hw = h * w;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  __shared__ float g[kMaxViews * 12];
  for (int i = threadIdx.x; i < Vs * 12; i += kThreads) g[i] = geom[((i / 12) * B + b) * 12 + i % 12];
  __syncthreads();
  if (pix >= hw) return;
  const float x = static_cast<float>(pix % w), y = static_cast<float>(pix / w);
  const size_t bp = static_cast<size_t>(b) * hw + pix;
  float r[C];
  Row<T, C>::load(ref + bp * C, r);
  const float l = lo[bp], st = step[bp];
  const float nv = static_cast<float>(Vs + 1);
  const size_t src_view = static_cast<size_t>(H) * W * C;
  const int d0 = blockIdx.z * kDChunk;
  const int d1 = min(D, d0 + kDChunk);
  float wv[C], s[C], sq[C];
  for (int d = d0; d < d1; ++d) {
    const float hyp = __fadd_rn(l, __fmul_rn(static_cast<float>(d), st));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      s[c] = r[c];
      sq[c] = __fmul_rn(r[c], r[c]);
    }
    for (int v = 0; v < Vs; ++v) {
      warp_sample<T, C>(src + (static_cast<size_t>(v) * B + b) * src_view, H, W, g + 12 * v, x, y,
                        hyp, wv);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s[c] = __fadd_rn(s[c], wv[c]);
        sq[c] = __fadd_rn(sq[c], __fmul_rn(wv[c], wv[c]));
      }
    }
    T* o = out + (static_cast<size_t>(d) * B + b) * C * hw + pix;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float m = __fdiv_rn(s[c], nv);
      store(o + static_cast<size_t>(c) * hw, __fsub_rn(__fdiv_rn(sq[c], nv), __fmul_rn(m, m)));
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

template <typename T, int C>
int launch_fused(int Vs, int B, int h, int w, int H, int W, int D, const void* ref, const void* src,
                 const void* geom, const void* lo, const void* step, const void* wn, void* out,
                 cudaStream_t s) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, B, (D + kDChunk - 1) / kDChunk);
  fused_kernel<T, C><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src), static_cast<const float*>(geom),
      static_cast<const float*>(lo), static_cast<const float*>(step), static_cast<const float*>(wn),
      static_cast<T*>(out), Vs, B, h, w, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_var(int Vs, int B, int h, int w, int H, int W, int D, const void* ref, const void* src,
               const void* geom, const void* lo, const void* step, void* out, cudaStream_t s) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, B, (D + kDChunk - 1) / kDChunk);
  var_kernel<T, C><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src), static_cast<const float*>(geom),
      static_cast<const float*>(lo), static_cast<const float*>(step), static_cast<T*>(out), Vs, B,
      h, w, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int var_for_channels(int C, int Vs, int B, int h, int w, int H, int W, int D, const void* ref,
                     const void* src, const void* geom, const void* lo, const void* step,
                     void* out, cudaStream_t s) {
  switch (C) {
    case 8: return launch_var<T, 8>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out, s);
    case 16: return launch_var<T, 16>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out, s);
    case 32: return launch_var<T, 32>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out, s);
    default: return adamvs::kBadChannels;
  }
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

template <typename T>
int fused_for_channels(int C, int Vs, int B, int h, int w, int H, int W, int D, const void* ref,
                       const void* src, const void* geom, const void* lo, const void* step,
                       const void* wn, void* out, cudaStream_t s) {
  switch (C) {
    case 8: return launch_fused<T, 8>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, wn, out, s);
    case 16: return launch_fused<T, 16>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, wn, out, s);
    case 32: return launch_fused<T, 32>(Vs, B, h, w, H, W, D, ref, src, geom, lo, step, wn, out, s);
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

// K2. Returns 0 or the launch error.
extern "C" int adamvs_fused_sweep(int dtype, int Vs, int B, int h, int w, int H, int W, int C,
                                  int D, const void* ref, const void* src, const void* geom,
                                  const void* lo, const void* step, const void* wn, void* out,
                                  void* stream) {
  if (Vs > kMaxViews) return adamvs::kBadViews;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32)
    return fused_for_channels<float>(C, Vs, B, h, w, H, W, D, ref, src, geom, lo, step, wn, out, s);
  if (dtype == adamvs::kBFloat16)
    return fused_for_channels<__nv_bfloat16>(C, Vs, B, h, w, H, W, D, ref, src, geom, lo, step,
                                             wn, out, s);
  return adamvs::kBadDtype;
}

// K4. Returns 0 or the launch error.
extern "C" int adamvs_var_sweep(int dtype, int Vs, int B, int h, int w, int H, int W, int C, int D,
                                const void* ref, const void* src, const void* geom, const void* lo,
                                const void* step, void* out, void* stream) {
  if (Vs > kMaxViews) return adamvs::kBadViews;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32)
    return var_for_channels<float>(C, Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out, s);
  if (dtype == adamvs::kBFloat16)
    return var_for_channels<__nv_bfloat16>(C, Vs, B, h, w, H, W, D, ref, src, geom, lo, step, out,
                                           s);
  return adamvs::kBadDtype;
}
