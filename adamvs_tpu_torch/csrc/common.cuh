// Helpers shared by the port's kernel sources: element conversion, 16-byte
// row loads and stores of NHWC features, the four bilinear taps of a source
// position, the sample positions of the plane sweeps, the asynchronous copies
// and shared-memory reads of staged source windows, the argument error codes
// the C entries return, and the error-string entry every library exports.
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
// ops/warp.py::bilinear_sample's order of operations.
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

// --- shared-memory staging of source windows (the tiled sweeps and their
// backward) ---

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

// rot.[x, y, 1] of the ref->src transform g = rot (row-major, 9) then trans
// (3), in the plain version's order of operations (ops/warp.py::
// _source_coords). It does not depend on the depth: the corr walks compute it
// once per reference pixel, the tiles once per pixel and view.
__device__ __forceinline__ void rot_xyz(const float* g, float x, float y, float* r) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = __fadd_rn(__fadd_rn(__fmul_rn(g[3 * i], x), __fmul_rn(g[3 * i + 1], y)), g[3 * i + 2]);
}

// Where the reference pixel whose rot_xyz is r lands in the source at depth
// hyp: p = r.hyp + t (t the transform's translation, g[9..11]), (u, v) =
// (p.x/p.z, p.y/p.z), as the plain version rounds it; (-1e9, -1e9), which has
// no tap in the image, when p.z <= 1e-6 (behind the camera, as the plain
// version).
__device__ __forceinline__ float2 sweep_position(const float* r, const float* t, float hyp) {
  float2 uv = make_float2(-1e9f, -1e9f);
  const float pz = __fadd_rn(__fmul_rn(r[2], hyp), t[2]);
  if (pz > 1e-6f) {
    uv.x = __fdiv_rn(__fadd_rn(__fmul_rn(r[0], hyp), t[0]), pz);
    uv.y = __fdiv_rn(__fadd_rn(__fmul_rn(r[1], hyp), t[1]), pz);
  }
  return uv;
}

// Whether some tap of t lies in the image (then t.x0, t.y0 are meaningful).
__device__ __forceinline__ bool any_tap(const TapGrid& t) {
  return t.ok[0] || t.ok[1] || t.ok[2] || t.ok[3];
}

// The taps of t that count in a corr walk, as bits k: tap k lies in the
// image and its weight is not 0. A tap of weight 0 adds 0 * (a finite dot
// product) in the plain version, so the walk neither computes its dot product
// (K1) nor adds to its coefficient (K5-corr).
__device__ __forceinline__ int walk_taps(const TapGrid& t) {
  return static_cast<int>(t.ok[0] && t.w[0] != 0.f) |
         static_cast<int>(t.ok[1] && t.w[1] != 0.f) << 1 |
         static_cast<int>(t.ok[2] && t.w[2] != 0.f) << 2 |
         static_cast<int>(t.ok[3] && t.w[3] != 0.f) << 3;
}

// A corr walk holds the 2x2 tap set of its last sample: tap j at (x0 + (j & 1),
// y0 + (j >> 1)) with a value each. When the corner moves by (ddx, ddy), held
// tap j stays in the set exactly when |ddx| <= 1, |ddy| <= 1 and (j & 1) - ddx
// and (j >> 1) - ddy are 0 or 1: staying() gives those taps as bits j, and
// move_bits() and move_values() carry bits and values from the old index j to
// the new one, (j & 1) - ddx + 2 ((j >> 1) - ddy). A new tap that no held tap
// became keeps a meaningless value and bit 0 after move_bits(staying() & b).
__device__ __forceinline__ int staying(int ddx, int ddy) {
  const int xs = ddx == 0 ? 0xf : ddx == 1 ? 0xa : ddx == -1 ? 0x5 : 0;
  const int ys = ddy == 0 ? 0xf : ddy == 1 ? 0xc : ddy == -1 ? 0x3 : 0;
  return xs & ys;
}

__device__ __forceinline__ int move_bits(int bits, int ddx, int ddy) {
  bits = ddx == 1 ? (bits >> 1) & 0x5 : ddx == -1 ? (bits << 1) & 0xa : bits;
  return ddy == 1 ? (bits >> 2) & 0x3 : ddy == -1 ? (bits << 2) & 0xc : bits;
}

__device__ __forceinline__ void move_values(float* v, int ddx, int ddy) {
  const float a0 = ddx == 1 ? v[1] : v[0], a1 = ddx == -1 ? v[0] : v[1];
  const float a2 = ddx == 1 ? v[3] : v[2], a3 = ddx == -1 ? v[2] : v[3];
  v[0] = ddy == 1 ? a2 : a0;
  v[1] = ddy == 1 ? a3 : a1;
  v[2] = ddy == -1 ? a0 : a2;
  v[3] = ddy == -1 ? a1 : a3;
}

// stats[0] += n and stats[1] += m summed over the calling warp's active
// lanes, one atomic each per warp: the corr walks' counts of samples and of
// dot products or flushes.
__device__ __forceinline__ void add_walk_counts(int* stats, int n, int m) {
  const unsigned lanes = __activemask();
  n = __reduce_add_sync(lanes, n);
  m = __reduce_add_sync(lanes, m);
  if (static_cast<int>(threadIdx.x % 32) == __ffs(lanes) - 1)
    atomicAdd(stats, n), atomicAdd(stats + 1, m);
}

// a[j] for j in 0..3 by selects, so that a stays in registers.
__device__ __forceinline__ float pick4(const float* a, int j) {
  return j == 0 ? a[0] : j == 1 ? a[1] : j == 2 ? a[2] : a[3];
}

}  // namespace adamvs

extern "C" const char* adamvs_error_string(int code) {
  switch (code) {
    case adamvs::kBadDtype: return "unsupported dtype";
    case adamvs::kBadChannels:
      return "unsupported channel count: a sweep launch takes 8, 16 or 32 channels, the sampler "
             "a multiple of 8; the Python wrappers pad and group every other width";
    case adamvs::kBadViews: return "too many source views";
    case adamvs::kBadBase: return "unsupported regulariser base width";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
