// Helpers shared by the port's kernel sources: element conversion, the
// argument error codes the C entries return, and the error-string entry every
// library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace adamvs {

// dtype codes of the C entries
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// argument errors (negative, so they never collide with a cudaError_t)
constexpr int kBadDtype = -1;
constexpr int kBadChannels = -2;
constexpr int kBadViews = -3;
constexpr int kBadBase = -4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

}  // namespace adamvs

extern "C" const char* adamvs_error_string(int code) {
  switch (code) {
    case adamvs::kBadDtype: return "unsupported dtype";
    case adamvs::kBadChannels: return "unsupported channel count";
    case adamvs::kBadViews: return "too many source views";
    case adamvs::kBadBase: return "unsupported regulariser base width";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
