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
// What bounds it on an H100: the forward's tap arithmetic again (the
// samples X_v are recomputed, for dref, dwn and the variance mean) plus one
// multiply-add per tap, channel and scatter target, at 67 TFLOP/s float32;
// at the full-resolution stage the bytes of g, ref, the sources and the
// gradients, each moved once in its own dtype. This kernel moves more: its
// scatter is float32 atomics into L2 (neighbouring reference pixels hit
// neighbouring source pixels), a float32 read-modify-write of dsrc.
//
// Design: the forward's thread layout, one thread per (batch, reference
// pixel, chunk of 8 hypotheses) (and per source view for corr); the samples
// come from common.cuh::sweep_taps and gather_taps, the forward's own code,
// so the scatter reaches exactly the taps the forward read. Taps outside the
// image and samples behind the camera contribute nothing. Everything
// accumulates in float32: dsrc is a zeroed float32 [Vs,B,H,W,C] that the
// taps reach with 16-byte vector atomics; dref [B,h,w,C] and dwn [B,Vs,h,w]
// are float32 too and take one atomic add per thread, since the hypothesis
// chunks of a pixel run in different threads. The wrapper casts the results
// to the primal dtypes. The var backward takes two passes over the views
// per hypothesis: the mean first, then the scatter. The order of the
// atomics varies from run to run, so the results are not bitwise
// reproducible.
//
// Layouts as the forward's: ref [B,h,w,C], src [Vs,B,H,W,C] (float32 or
// bfloat16), geom [Vs*B,12] float32, lo/step [B,h,w] float32.

#include "common.cuh"

namespace {

using adamvs::Row;
using adamvs::Taps;
using adamvs::to_f32;

constexpr int kThreads = 128;
constexpr int kDChunk = 8;
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

// dst [H*W, C] float32 += w_k * row at each valid tap k of t.
template <int C>
__device__ __forceinline__ void scatter_taps(float* __restrict__ dst, const Taps& t,
                                             const float* row) {
  float v[C];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.idx[k] >= 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = __fmul_rn(t.w[k], row[c]);
      atomic_add_row<C>(dst + static_cast<size_t>(t.idx[k]) * C, v);
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
corr_bwd_kernel(const float* __restrict__ gout, const T* __restrict__ ref,
                const T* __restrict__ src, const float* __restrict__ geom,
                const float* __restrict__ lo, const float* __restrict__ step,
                float* __restrict__ dref, float* __restrict__ dsrc, int B, int h, int w, int H,
                int W, int D) {
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
  const size_t view = static_cast<size_t>(vb) * H * W * C;
  const int d0 = blockIdx.z * kDChunk;
  const int d1 = min(D, d0 + kDChunk);
  float acc[C], xs[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int d = d0; d < d1; ++d) {
    const float gd = __fdiv_rn(gout[(static_cast<size_t>(vb) * D + d) * hw + pix],
                               static_cast<float>(C));
    const float hyp = __fadd_rn(l, __fmul_rn(static_cast<float>(d), st));
    const Taps t = adamvs::sweep_taps(g, x, y, hyp, H, W);
    adamvs::gather_taps<T, C>(src + view, t, xs);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] = fmaf(gd, xs[c], acc[c]);
      xs[c] = __fmul_rn(gd, r[c]);
    }
    scatter_taps<C>(dsrc + view, t, xs);
  }
  atomic_add_row<C>(dref + bp * C, acc);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_bwd_kernel(const T* __restrict__ gout, const T* __restrict__ ref,
                 const T* __restrict__ src, const float* __restrict__ geom,
                 const float* __restrict__ lo, const float* __restrict__ step,
                 const float* __restrict__ wn, float* __restrict__ dref,
                 float* __restrict__ dwn, float* __restrict__ dsrc, int Vs, int B, int h, int w,
                 int H, int W, int D) {
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
  float acc[C], xs[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int v = 0; v < Vs; ++v) {
    const size_t wi = (static_cast<size_t>(b) * Vs + v) * hw + pix;
    const float wt = wn[wi];
    const size_t view = (static_cast<size_t>(v) * B + b) * src_view;
    float dw = 0.f;
    for (int d = d0; d < d1; ++d) {
      const float hyp = __fadd_rn(l, __fmul_rn(static_cast<float>(d), st));
      const Taps t = adamvs::sweep_taps(g + 12 * v, x, y, hyp, H, W);
      adamvs::gather_taps<T, C>(src + view, t, xs);
      const T* gp = gout + (static_cast<size_t>(d) * B + b) * C * hw + pix;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float gc = to_f32(gp[static_cast<size_t>(c) * hw]);
        const float gr = __fmul_rn(gc, r[c]);
        dw = fmaf(gr, xs[c], dw);
        acc[c] = fmaf(__fmul_rn(gc, wt), xs[c], acc[c]);
        xs[c] = __fmul_rn(gr, wt);
      }
      scatter_taps<C>(dsrc + view, t, xs);
    }
    atomicAdd(dwn + wi, dw);
  }
  atomic_add_row<C>(dref + bp * C, acc);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
var_bwd_kernel(const T* __restrict__ gout, const T* __restrict__ ref, const T* __restrict__ src,
               const float* __restrict__ geom, const float* __restrict__ lo,
               const float* __restrict__ step, float* __restrict__ dref,
               float* __restrict__ dsrc, int Vs, int B, int h, int w, int H, int W, int D) {
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
  const float k2 = __fdiv_rn(2.f, nv);
  const size_t src_view = static_cast<size_t>(H) * W * C;
  const int d0 = blockIdx.z * kDChunk;
  const int d1 = min(D, d0 + kDChunk);
  float acc[C], m[C], xs[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int d = d0; d < d1; ++d) {
    const float hyp = __fadd_rn(l, __fmul_rn(static_cast<float>(d), st));
    // pass 1: the mean over {ref, X_1 .. X_Vs}, summed in the forward's order
#pragma unroll
    for (int c = 0; c < C; ++c) m[c] = r[c];
    for (int v = 0; v < Vs; ++v) {
      const Taps t = adamvs::sweep_taps(g + 12 * v, x, y, hyp, H, W);
      adamvs::gather_taps<T, C>(src + (static_cast<size_t>(v) * B + b) * src_view, t, xs);
#pragma unroll
      for (int c = 0; c < C; ++c) m[c] = __fadd_rn(m[c], xs[c]);
    }
    const T* gp = gout + (static_cast<size_t>(d) * B + b) * C * hw + pix;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      m[c] = __fdiv_rn(m[c], nv);
      acc[c] = fmaf(__fmul_rn(k2, to_f32(gp[static_cast<size_t>(c) * hw])),
                    __fsub_rn(r[c], m[c]), acc[c]);
    }
    // pass 2: each view's samples again, scattered as g (2/nv)(X_v - m)
    for (int v = 0; v < Vs; ++v) {
      const size_t view = (static_cast<size_t>(v) * B + b) * src_view;
      const Taps t = adamvs::sweep_taps(g + 12 * v, x, y, hyp, H, W);
      adamvs::gather_taps<T, C>(src + view, t, xs);
#pragma unroll
      for (int c = 0; c < C; ++c)
        xs[c] = __fmul_rn(__fmul_rn(k2, to_f32(gp[static_cast<size_t>(c) * hw])),
                          __fsub_rn(xs[c], m[c]));
      scatter_taps<C>(dsrc + view, t, xs);
    }
  }
  atomic_add_row<C>(dref + bp * C, acc);
}

template <typename T, int C>
struct CorrBwd {
  static int run(int Vs, int B, int h, int w, int H, int W, int D, const void* g, const void* ref,
                 const void* src, const void* geom, const void* lo, const void* step, void* dref,
                 void* dsrc, cudaStream_t s) {
    const dim3 grid((h * w + kThreads - 1) / kThreads, Vs * B, (D + kDChunk - 1) / kDChunk);
    corr_bwd_kernel<T, C><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const T*>(ref), static_cast<const T*>(src),
        static_cast<const float*>(geom), static_cast<const float*>(lo),
        static_cast<const float*>(step), static_cast<float*>(dref), static_cast<float*>(dsrc), B,
        h, w, H, W, D);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int C>
struct FusedBwd {
  static int run(int Vs, int B, int h, int w, int H, int W, int D, const void* g, const void* ref,
                 const void* src, const void* geom, const void* lo, const void* step,
                 const void* wn, void* dref, void* dwn, void* dsrc, cudaStream_t s) {
    const dim3 grid((h * w + kThreads - 1) / kThreads, B, (D + kDChunk - 1) / kDChunk);
    fused_bwd_kernel<T, C><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(ref), static_cast<const T*>(src),
        static_cast<const float*>(geom), static_cast<const float*>(lo),
        static_cast<const float*>(step), static_cast<const float*>(wn), static_cast<float*>(dref),
        static_cast<float*>(dwn), static_cast<float*>(dsrc), Vs, B, h, w, H, W, D);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int C>
struct VarBwd {
  static int run(int Vs, int B, int h, int w, int H, int W, int D, const void* g, const void* ref,
                 const void* src, const void* geom, const void* lo, const void* step, void* dref,
                 void* dsrc, cudaStream_t s) {
    const dim3 grid((h * w + kThreads - 1) / kThreads, B, (D + kDChunk - 1) / kDChunk);
    var_bwd_kernel<T, C><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(ref), static_cast<const T*>(src),
        static_cast<const float*>(geom), static_cast<const float*>(lo),
        static_cast<const float*>(step), static_cast<float*>(dref), static_cast<float*>(dsrc), Vs,
        B, h, w, H, W, D);
    return static_cast<int>(cudaGetLastError());
  }
};

// Launch<T, C>::run for the feature dtype code and channel count.
template <template <typename, int> class Launch, typename... A>
int dispatch(int dtype, int C, A... a) {
  if (dtype == adamvs::kFloat32) {
    switch (C) {
      case 8: return Launch<float, 8>::run(a...);
      case 16: return Launch<float, 16>::run(a...);
      case 32: return Launch<float, 32>::run(a...);
      default: return adamvs::kBadChannels;
    }
  }
  if (dtype == adamvs::kBFloat16) {
    switch (C) {
      case 8: return Launch<__nv_bfloat16, 8>::run(a...);
      case 16: return Launch<__nv_bfloat16, 16>::run(a...);
      case 32: return Launch<__nv_bfloat16, 32>::run(a...);
      default: return adamvs::kBadChannels;
    }
  }
  return adamvs::kBadDtype;
}

}  // namespace

// K5, corr. dref and dsrc must be zeroed float32. Returns 0 or the launch error.
extern "C" int adamvs_corr_sweep_bwd(int dtype, int Vs, int B, int h, int w, int H, int W, int C,
                                     int D, const void* g, const void* ref, const void* src,
                                     const void* geom, const void* lo, const void* step,
                                     void* dref, void* dsrc, void* stream) {
  return dispatch<CorrBwd>(dtype, C, Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, dref, dsrc,
                           static_cast<cudaStream_t>(stream));
}

// K5, fused. dref, dwn and dsrc must be zeroed float32. Returns 0 or the
// launch error.
extern "C" int adamvs_fused_sweep_bwd(int dtype, int Vs, int B, int h, int w, int H, int W, int C,
                                      int D, const void* g, const void* ref, const void* src,
                                      const void* geom, const void* lo, const void* step,
                                      const void* wn, void* dref, void* dwn, void* dsrc,
                                      void* stream) {
  if (Vs > kMaxViews) return adamvs::kBadViews;
  return dispatch<FusedBwd>(dtype, C, Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, wn, dref,
                            dwn, dsrc, static_cast<cudaStream_t>(stream));
}

// K5, var. dref and dsrc must be zeroed float32. Returns 0 or the launch error.
extern "C" int adamvs_var_sweep_bwd(int dtype, int Vs, int B, int h, int w, int H, int W, int C,
                                    int D, const void* g, const void* ref, const void* src,
                                    const void* geom, const void* lo, const void* step, void* dref,
                                    void* dsrc, void* stream) {
  if (Vs > kMaxViews) return adamvs::kBadViews;
  return dispatch<VarBwd>(dtype, C, Vs, B, h, w, H, W, D, g, ref, src, geom, lo, step, dref, dsrc,
                          static_cast<cudaStream_t>(stream));
}
