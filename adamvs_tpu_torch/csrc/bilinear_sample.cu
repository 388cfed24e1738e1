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
// Design: one thread per (b, n, output pixel). The thread computes floor(u),
// floor(v) and the four hat weights exactly as the plain version does
// (common.cuh::bilinear_taps, shared with the sweep kernels), reads each
// valid tap's C channels as 16-byte vectors, accumulates in float32 and
// writes its C channels as 16-byte vectors, so a warp's stores are one
// contiguous stretch. The TPU kernels' band DMAs and hat-function matmuls
// are TPU artefacts and are not copied: the gather is exact for every
// sample, where a TPU kernel zeroes taps outside its band.
//
// Layouts: feat [B,H,W,C] float32 or bfloat16, u/v [B,N,h,w] float32,
// out [B,N,h,w,C] in the feature dtype.

#include "common.cuh"

namespace {

using adamvs::Row;

constexpr int kThreads = 128;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ feat, const float* __restrict__ u, const float* __restrict__ v,
              T* __restrict__ out, int N, int hw, int H, int W) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int bn = blockIdx.y;  // b * N + n
  const size_t i = static_cast<size_t>(bn) * hw + pix;
  const T* src = feat + static_cast<size_t>(bn / N) * H * W * C;
  float acc[C];
  adamvs::bilinear_taps<T, C>(src, H, W, u[i], v[i], acc);
  Row<T, C>::store(out + i * C, acc);
}

template <typename T, int C>
int launch(int B, int N, int hw, int H, int W, const void* feat, const void* u, const void* v,
           void* out, cudaStream_t s) {
  const dim3 grid((hw + kThreads - 1) / kThreads, B * N);
  sample_kernel<T, C><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feat), static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<T*>(out), N, hw, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int for_channels(int C, int B, int N, int hw, int H, int W, const void* feat, const void* u,
                 const void* v, void* out, cudaStream_t s) {
  switch (C) {
    case 8: return launch<T, 8>(B, N, hw, H, W, feat, u, v, out, s);
    case 16: return launch<T, 16>(B, N, hw, H, W, feat, u, v, out, s);
    case 32: return launch<T, 32>(B, N, hw, H, W, feat, u, v, out, s);
    default: return adamvs::kBadChannels;
  }
}

}  // namespace

// K6/K7. Returns 0 or the launch error.
extern "C" int adamvs_bilinear_sample(int dtype, int B, int N, int h, int w, int H, int W, int C,
                                      const void* feat, const void* u, const void* v, void* out,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32) return for_channels<float>(C, B, N, h * w, H, W, feat, u, v, out, s);
  if (dtype == adamvs::kBFloat16)
    return for_channels<__nv_bfloat16>(C, B, N, h * w, H, W, feat, u, v, out, s);
  return adamvs::kBadDtype;
}
