// Helpers shared by the port's kernel sources: element conversion, 16-byte
// row loads and stores of NHWC features, the four-tap bilinear gather, the
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

// One pixel's C channels of an NHWC tensor, moved as 16-byte vectors and
// held as float32.
template <typename T, int C>
struct Row;

template <int C>
struct Row<float, C> {
  static_assert(C % 4 == 0, "float32 rows move as float4");
  __device__ __forceinline__ static void load(const float* __restrict__ p, float* v) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 a = __ldg(q + i);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  }
  __device__ __forceinline__ static void store(float* __restrict__ p, const float* v) {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int i = 0; i < C / 4; ++i)
      q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
};

template <int C>
struct Row<__nv_bfloat16, C> {
  static_assert(C % 8 == 0, "bfloat16 rows move as 16-byte vectors");
  __device__ __forceinline__ static void load(const __nv_bfloat16* __restrict__ p, float* v) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < C / 8; ++i) {
      const uint4 a = __ldg(q + i);
      const uint32_t words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // element 2j is the low half of the word, 2j+1 the high half
        v[8 * i + 2 * j] = __uint_as_float(words[j] << 16);
        v[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
      }
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* __restrict__ p, const float* v) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < C / 8; ++i) {
      uint32_t words[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // round to nearest even, as a cast to bfloat16 in PyTorch does
        const __nv_bfloat162 pr = __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
        words[j] = *reinterpret_cast<const uint32_t*>(&pr);
      }
      q[i] = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
};

// The four bilinear taps of pixel coordinates (u, v) over an H x W source,
// in the order (u0,v0), (u0+1,v0), (u0,v0+1), (u0+1,v0+1): each tap's pixel
// index yi*W + xi, or -1 when it lies outside the image, and its weight. A
// tap counts only when 0 <= xi <= W-1 and 0 <= yi <= H-1, so a sample at
// -1e9 (behind the camera) has no tap. The weights follow
// ops/warp.py::bilinear_sample's order of operations. The gathers read, and
// the sweep backward (sweep_bwd.cu) scatters to, exactly these taps.
struct Taps {
  int idx[4];
  float w[4];
};

__device__ __forceinline__ Taps bilinear_tap_set(int H, int W, float u, float v) {
  Taps t;
  const float u0 = floorf(u), v0 = floorf(v);
  const float du = __fsub_rn(u, u0), dv = __fsub_rn(v, v0);
  const float eu = __fsub_rn(1.f, du), ev = __fsub_rn(1.f, dv);
  const float u1 = __fadd_rn(u0, 1.f), v1 = __fadd_rn(v0, 1.f);
  const float xs[4] = {u0, u1, u0, u1};
  const float ys[4] = {v0, v0, v1, v1};
  t.w[0] = __fmul_rn(eu, ev);
  t.w[1] = __fmul_rn(du, ev);
  t.w[2] = __fmul_rn(eu, dv);
  t.w[3] = __fmul_rn(du, dv);
  const float xmax = static_cast<float>(W - 1), ymax = static_cast<float>(H - 1);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    t.idx[k] = (xs[k] >= 0.f && xs[k] <= xmax && ys[k] >= 0.f && ys[k] <= ymax)
                   ? static_cast<int>(ys[k]) * W + static_cast<int>(xs[k])
                   : -1;
  return t;
}

// The same four taps as integer positions: tap k lies at (x0 + (k & 1),
// y0 + (k >> 1)) and counts when ok[k]. x0 and y0 are meaningful only where
// some tap counts (then -1 <= x0 <= W-1, -1 <= y0 <= H-1). The direct
// gather of the tiled sweeps (sweep_fuse.cu) reads the source with it.
struct TapGrid {
  int x0, y0;
  float w[4];
  bool ok[4];
};

__device__ __forceinline__ TapGrid bilinear_tap_grid(int H, int W, float u, float v) {
  TapGrid t;
  const float u0 = floorf(u), v0 = floorf(v);
  const float du = __fsub_rn(u, u0), dv = __fsub_rn(v, v0);
  const float eu = __fsub_rn(1.f, du), ev = __fsub_rn(1.f, dv);
  const float u1 = __fadd_rn(u0, 1.f), v1 = __fadd_rn(v0, 1.f);
  t.w[0] = __fmul_rn(eu, ev);
  t.w[1] = __fmul_rn(du, ev);
  t.w[2] = __fmul_rn(eu, dv);
  t.w[3] = __fmul_rn(du, dv);
  const float xmax = static_cast<float>(W - 1), ymax = static_cast<float>(H - 1);
  const bool x0ok = u0 >= 0.f && u0 <= xmax, x1ok = u1 >= 0.f && u1 <= xmax;
  const bool y0ok = v0 >= 0.f && v0 <= ymax, y1ok = v1 >= 0.f && v1 <= ymax;
  t.ok[0] = x0ok && y0ok;
  t.ok[1] = x1ok && y0ok;
  t.ok[2] = x0ok && y1ok;
  t.ok[3] = x1ok && y1ok;
  // clamped so that the conversion is defined for every u, v (NaN included)
  t.x0 = static_cast<int>(fminf(fmaxf(u0, -1.f), xmax));
  t.y0 = static_cast<int>(fminf(fmaxf(v0, -1.f), ymax));
  return t;
}

// The taps of a sample behind the camera: none.
__device__ __forceinline__ Taps no_taps() {
  Taps t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t.idx[k] = -1;
    t.w[k] = 0.f;
  }
  return t;
}

// Bilinear sample (zeros padding) of src [H,W,C] at the taps t, in float32,
// into out: the valid taps summed in order.
template <typename T, int C>
__device__ __forceinline__ void gather_taps(const T* __restrict__ src, const Taps& t, float* out) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = 0.f;
  float vals[C];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.idx[k] >= 0) {
      Row<T, C>::load(src + static_cast<size_t>(t.idx[k]) * C, vals);
#pragma unroll
      for (int c = 0; c < C; ++c) out[c] = __fadd_rn(out[c], __fmul_rn(vals[c], t.w[k]));
    }
  }
}

// Bilinear sample (zeros padding) of src [H,W,C] at pixel coordinates (u, v),
// in float32, into out.
template <typename T, int C>
__device__ __forceinline__ void bilinear_taps(const T* __restrict__ src, int H, int W, float u,
                                              float v, float* out) {
  gather_taps<T, C>(src, bilinear_tap_set(H, W, u, v), out);
}

// The taps in an H x W source of reference pixel (x, y) at depth hyp, under
// the ref->src transform g = rot (row-major, 9) then trans (3):
// p = rot.[x,y,1].hyp + trans, (u, v) = (p.x/p.z, p.y/p.z), none when
// p.z <= 1e-6 (behind the camera). The order of operations is the plain
// version's (ops/warp.py::_source_coords), so both sample the same positions.
__device__ __forceinline__ Taps sweep_taps(const float* g, float x, float y, float hyp, int H,
                                           int W) {
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float rxyz =
        __fadd_rn(__fadd_rn(__fmul_rn(g[3 * i], x), __fmul_rn(g[3 * i + 1], y)), g[3 * i + 2]);
    p[i] = __fadd_rn(__fmul_rn(rxyz, hyp), g[9 + i]);
  }
  if (!(p[2] > 1e-6f)) return no_taps();
  return bilinear_tap_set(H, W, __fdiv_rn(p[0], p[2]), __fdiv_rn(p[1], p[2]));
}

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
