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
// bilinear_sample. The MS-REDNet scan form calls it once per source view and
// hypothesis with N = 1.
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
// and valid tap, with the forward's taps and weights (bilinear_tap_set).
// Bound: bytes, as the forward (dout, u and v read once, dfeat written
// once). Design: one thread per (sample, channel group of CB), as the
// forward; it reads its CB channels of dout as 16-byte vectors and adds
// w_tap * dout into each valid tap's row of a float32 dfeat with float4
// atomics (sm_90 offers them on global memory). Neighbouring samples hit
// neighbouring source pixels, so the atomics mostly meet in L2. The wrapper
// zeroes dfeat and casts it to the feature dtype afterwards; the order of
// the atomic sums varies from run to run.

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

// K6/K7-bwd: dfeat [B,H,W,C] float32 (zeroed by the caller) += the
// transpose of the sampling applied to dout [B,N,h,w,C].
template <typename T, int CB>
__global__ void __launch_bounds__(kThreads)
sample_bwd_kernel(const T* __restrict__ dout, const float* __restrict__ u,
                  const float* __restrict__ v, float* __restrict__ dfeat, int N, int hw, int H,
                  int W, int C) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int bn = blockIdx.y;  // b * N + n
  const int c0 = blockIdx.z * CB;
  const size_t i = static_cast<size_t>(bn) * hw + pix;
  const adamvs::Taps t = adamvs::bilinear_tap_set(H, W, u[i], v[i]);
  if (t.idx[0] < 0 && t.idx[1] < 0 && t.idx[2] < 0 && t.idx[3] < 0) return;
  float g[CB], val[CB];
  Row<T, CB>::load(dout + i * C + c0, g);
  float* dst = dfeat + static_cast<size_t>(bn / N) * H * W * C + c0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.idx[k] >= 0) {
#pragma unroll
      for (int c = 0; c < CB; ++c) val[c] = __fmul_rn(g[c], t.w[k]);
      float4* q = reinterpret_cast<float4*>(dst + static_cast<size_t>(t.idx[k]) * C);
#pragma unroll
      for (int j = 0; j < CB / 4; ++j)
        atomicAdd(q + j, make_float4(val[4 * j], val[4 * j + 1], val[4 * j + 2], val[4 * j + 3]));
    }
  }
}

template <typename T, int CB>
int launch_bwd(int B, int N, int hw, int H, int W, int C, const void* dout, const void* u,
               const void* v, void* dfeat, cudaStream_t s) {
  const dim3 grid((hw + kThreads - 1) / kThreads, B * N, C / CB);
  sample_bwd_kernel<T, CB><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dout), static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<float*>(dfeat), N, hw, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int for_channels_bwd(int C, int B, int N, int hw, int H, int W, const void* dout, const void* u,
                     const void* v, void* dfeat, cudaStream_t s) {
  if (C <= 0 || C % 8) return adamvs::kBadChannels;
  if (C % 32 == 0) return launch_bwd<T, 32>(B, N, hw, H, W, C, dout, u, v, dfeat, s);
  if (C % 16 == 0) return launch_bwd<T, 16>(B, N, hw, H, W, C, dout, u, v, dfeat, s);
  return launch_bwd<T, 8>(B, N, hw, H, W, C, dout, u, v, dfeat, s);
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
// feature dtype (C a multiple of 8). Returns 0 or the launch error.
extern "C" int adamvs_bilinear_sample_bwd(int dtype, int B, int N, int h, int w, int H, int W,
                                          int C, const void* dout, const void* u, const void* v,
                                          void* dfeat, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32)
    return for_channels_bwd<float>(C, B, N, h * w, H, W, dout, u, v, dfeat, s);
  if (dtype == adamvs::kBFloat16)
    return for_channels_bwd<__nv_bfloat16>(C, B, N, h * w, H, W, dout, u, v, dfeat, s);
  return adamvs::kBadDtype;
}
