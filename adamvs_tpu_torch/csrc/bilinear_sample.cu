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
// out [B,N,h,w,C] in the feature dtype.

#include "common.cuh"

namespace {

using adamvs::Row;

constexpr int kThreads = 128;

template <typename T, int CB>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ feat, const float* __restrict__ u, const float* __restrict__ v,
              T* __restrict__ out, int N, int hw, int H, int W, int C) {
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
  Row<T, CB>::store(out + i * C + c0, acc);
}

template <typename T, int CB>
int launch(int B, int N, int hw, int H, int W, int C, const void* feat, const void* u,
           const void* v, void* out, cudaStream_t s) {
  const dim3 grid((hw + kThreads - 1) / kThreads, B * N, C / CB);
  sample_kernel<T, CB><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feat), static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<T*>(out), N, hw, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// The widest channel group that divides C (a multiple of 8).
template <typename T>
int for_channels(int C, int B, int N, int hw, int H, int W, const void* feat, const void* u,
                 const void* v, void* out, cudaStream_t s) {
  if (C <= 0 || C % 8) return adamvs::kBadChannels;
  if (C % 32 == 0) return launch<T, 32>(B, N, hw, H, W, C, feat, u, v, out, s);
  if (C % 16 == 0) return launch<T, 16>(B, N, hw, H, W, C, feat, u, v, out, s);
  return launch<T, 8>(B, N, hw, H, W, C, feat, u, v, out, s);
}

}  // namespace

// K6/K7 on features of C channels, a multiple of 8. Returns 0 or the launch
// error.
extern "C" int adamvs_bilinear_sample(int dtype, int B, int N, int h, int w, int H, int W, int C,
                                      const void* feat, const void* u, const void* v, void* out,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32) return for_channels<float>(C, B, N, h * w, H, W, feat, u, v, out, s);
  if (dtype == adamvs::kBFloat16)
    return for_channels<__nv_bfloat16>(C, B, N, h * w, H, W, feat, u, v, out, s);
  return adamvs::kBadDtype;
}
