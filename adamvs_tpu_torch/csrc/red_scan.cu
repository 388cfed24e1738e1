// The AdaRedCell recurrence over depth: kernel K3.
//
// Replaces the Pallas kernel adamvs_tpu/ops/red_scan.py::_red_scan_kernel
// (:348), called through ada_red_scan (:542, pallas_call :591). For every
// depth slice d of the fused volume, in order:
//   c1 = relu(conv3x3(x_d))                        cin -> b
//   h1 = GRU(h1, c1)                               b, at h x w
//   c2 = relu(conv3x3 stride 2(h1))                b -> 2b, at h/2 x w/2
//   h2 = GRU(h2, c2)                               2b, at h/2 x w/2
//   u1 = relu(deconv stride 2(h2) + bias + h1)     2b -> b, at h x w
//   cost_d = deconv stride 2(u1) + bias (up)  or  conv3x3(u1) + bias
// where GRU(h, x): r, u = sigmoid(conv([x, h]) + b_g); c = tanh(conv([x, r*h])
// + b_c); h' = u*h + (1-u)*c. Convolutions use PyTorch padding 1; the
// transposed convolutions follow ConvTranspose2d(k=3, stride=2, padding=1,
// output_padding=1), so the output is exactly 2x.
//
// What bounds it on an H100: operations. The step's convolutions do about
// 8.7k multiply-adds per pixel of the h x w level at base 8, against a few
// bytes per pixel of input and output; this simple kernel runs them as
// float32 FMAs on the CUDA cores (67 TFLOP/s), not on the tensor cores.
//
// Design: the host loops over d on one stream, with no synchronisation; each
// step launches eight direct-convolution kernels, each with its pointwise
// epilogue fused (ReLU, the GRU gates with r*h, the GRU update, the skip add).
// A launch boundary is the grid-wide barrier that keeps the recurrence exact
// across tile borders, which the TPU kernel got from its HBM carry ping-pong.
// One thread computes every output channel of one output pixel; the layer's
// weights sit in shared memory as [(ci, ky, kx)][co] float32. The GRU states
// h1 and h2 live in the scratch buffer and are updated in place: the kernel
// that writes a state reads it only at its own pixel, and every kernel that
// reads neighbouring state pixels runs in a launch before or after it.
// Loads and stores are float32 or bfloat16; all arithmetic is float32. The TPU
// kernel's lane-sparse half-resolution layout, panel loop and matrix packing
// are Mosaic workarounds and are not copied.
//
// Layouts: vol [D,B,cin,h,w], cost [D,B,oh,ow], GRU states NCHW. h and w must
// be even. Scratch holds 5 [B,b,h,w] and 4 [B,2b,h/2,w/2] planes.

#include "common.cuh"

namespace {

using adamvs::store;
using adamvs::to_f32;

enum Epilogue { kRelu = 0, kGates = 1, kCand = 2, kSkipRelu = 3, kBias = 4 };
enum Kind { kConv = 0, kConvStride2 = 1, kDeconvStride2 = 2 };

constexpr int kBX = 32;
constexpr int kBY = 8;

struct ConvArgs {
  const void* in0;  // first input, c0 channels
  int c0;
  const void* in1;  // second input (channel concat after in0), c1 channels
  int c1;
  int Hi, Wi;
  const float* w;     // [(c0 + c1) * 9][CO], taps ordered (ci, ky, kx)
  const float* bias;  // [CO], or null for kRelu
  void* out0;         // kRelu/kSkipRelu/kBias: output; kGates: r*h
  void* out1;         // kGates: update gate u
  void* h;            // kGates: GRU state read; kCand: GRU state updated in place
  const void* aux;    // kCand: update gate u; kSkipRelu: skip input
  int Ho, Wo;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T, int CO, int EPI, int KIND>
__global__ void __launch_bounds__(kBX * kBY) cell_conv(ConvArgs a) {
  extern __shared__ float ws[];
  const int nci = a.c0 + a.c1;
  const int nw = nci * 9 * CO;
  for (int i = threadIdx.y * kBX + threadIdx.x; i < nw; i += kBX * kBY) ws[i] = a.w[i];
  __syncthreads();
  const int ox = blockIdx.x * kBX + threadIdx.x;
  const int oy = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (ox >= a.Wo || oy >= a.Ho) return;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;
  const size_t plane = static_cast<size_t>(a.Hi) * a.Wi;
  const T* in0 = static_cast<const T*>(a.in0) + static_cast<size_t>(b) * a.c0 * plane;
  const T* in1 = static_cast<const T*>(a.in1) + static_cast<size_t>(b) * a.c1 * plane;
  for (int ci = 0; ci < nci; ++ci) {
    const T* p = ci < a.c0 ? in0 + ci * plane : in1 + (ci - a.c0) * plane;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      int iy;
      if (KIND == kDeconvStride2) {
        const int t = oy + 1 - ky;  // oy = 2*iy - 1 + ky
        if (t & 1) continue;
        iy = t >> 1;
      } else {
        iy = oy * (KIND == kConvStride2 ? 2 : 1) - 1 + ky;
      }
      if (iy < 0 || iy >= a.Hi) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        int ix;
        if (KIND == kDeconvStride2) {
          const int t = ox + 1 - kx;
          if (t & 1) continue;
          ix = t >> 1;
        } else {
          ix = ox * (KIND == kConvStride2 ? 2 : 1) - 1 + kx;
        }
        if (ix < 0 || ix >= a.Wi) continue;
        const float xv = to_f32(p[static_cast<size_t>(iy) * a.Wi + ix]);
        const float* wr = ws + (ci * 9 + ky * 3 + kx) * CO;
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[co] = fmaf(wr[co], xv, acc[co]);
      }
    }
  }

  const size_t po = static_cast<size_t>(a.Ho) * a.Wo;
  const size_t pix = static_cast<size_t>(oy) * a.Wo + ox;
  if constexpr (EPI == kRelu) {
    T* o = static_cast<T*>(a.out0) + static_cast<size_t>(b) * CO * po + pix;
#pragma unroll
    for (int co = 0; co < CO; ++co) store(o + co * po, fmaxf(acc[co], 0.f));
  } else if constexpr (EPI == kGates) {
    constexpr int HID = CO / 2;
    const size_t off = static_cast<size_t>(b) * HID * po + pix;
    const T* h = static_cast<const T*>(a.h) + off;
    T* rh = static_cast<T*>(a.out0) + off;
    T* ug = static_cast<T*>(a.out1) + off;
#pragma unroll
    for (int k = 0; k < HID; ++k) {
      const float r = sigmoid(acc[k] + a.bias[k]);
      const float u = sigmoid(acc[HID + k] + a.bias[HID + k]);
      store(rh + k * po, r * to_f32(h[k * po]));
      store(ug + k * po, u);
    }
  } else if constexpr (EPI == kCand) {
    const size_t off = static_cast<size_t>(b) * CO * po + pix;
    T* h = static_cast<T*>(a.h) + off;
    const T* ug = static_cast<const T*>(a.aux) + off;
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const float c = tanhf(acc[k] + a.bias[k]);
      const float u = to_f32(ug[k * po]);
      store(h + k * po, u * to_f32(h[k * po]) + (1.f - u) * c);
    }
  } else if constexpr (EPI == kSkipRelu) {
    const size_t off = static_cast<size_t>(b) * CO * po + pix;
    const T* skip = static_cast<const T*>(a.aux) + off;
    T* o = static_cast<T*>(a.out0) + off;
#pragma unroll
    for (int co = 0; co < CO; ++co)
      store(o + co * po, fmaxf(acc[co] + a.bias[co] + to_f32(skip[co * po]), 0.f));
  } else {
    T* o = static_cast<T*>(a.out0) + static_cast<size_t>(b) * CO * po + pix;
#pragma unroll
    for (int co = 0; co < CO; ++co) store(o + co * po, acc[co] + a.bias[co]);
  }
}

template <typename T, int CO, int EPI, int KIND>
void launch(const ConvArgs& a, int B, cudaStream_t s) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.Wo + kBX - 1) / kBX, (a.Ho + kBY - 1) / kBY, B);
  const size_t smem = static_cast<size_t>(a.c0 + a.c1) * 9 * CO * sizeof(float);
  cell_conv<T, CO, EPI, KIND><<<grid, block, smem, s>>>(a);
}

// weights: wc1, wg1, bg1, wn1, bn1, wc2, wg2, bg2, wn2, bn2, wu1, bu1, wh, bh
template <typename T, int BASE>
int run(int cin, int up, int D, int B, int h, int w, const T* vol, const float* const* wt, T* cost,
        T* scratch, cudaStream_t s) {
  constexpr int b = BASE;
  const int hh = h / 2, wh = w / 2;
  const size_t n1 = static_cast<size_t>(B) * b * h * w;
  const size_t n2 = static_cast<size_t>(B) * 2 * b * hh * wh;
  T* h1 = scratch;
  T* h2 = h1 + n1;
  T* c1 = h2 + n2;
  T* rh1 = c1 + n1;
  T* ug1 = rh1 + n1;
  T* u1 = ug1 + n1;
  T* c2 = u1 + n1;
  T* rh2 = c2 + n2;
  T* ug2 = rh2 + n2;
  cudaError_t e = cudaMemsetAsync(h1, 0, (n1 + n2) * sizeof(T), s);  // zero GRU states
  if (e != cudaSuccess) return static_cast<int>(e);
  const int oh = up ? 2 * h : h, ow = up ? 2 * w : w;
  for (int d = 0; d < D; ++d) {
    const T* x = vol + static_cast<size_t>(d) * B * cin * h * w;
    T* out = cost + static_cast<size_t>(d) * B * oh * ow;
    launch<T, b, kRelu, kConv>(
        ConvArgs{x, cin, nullptr, 0, h, w, wt[0], nullptr, c1, nullptr, nullptr, nullptr, h, w}, B, s);
    launch<T, 2 * b, kGates, kConv>(
        ConvArgs{c1, b, h1, b, h, w, wt[1], wt[2], rh1, ug1, h1, nullptr, h, w}, B, s);
    launch<T, b, kCand, kConv>(
        ConvArgs{c1, b, rh1, b, h, w, wt[3], wt[4], nullptr, nullptr, h1, ug1, h, w}, B, s);
    launch<T, 2 * b, kRelu, kConvStride2>(
        ConvArgs{h1, b, nullptr, 0, h, w, wt[5], nullptr, c2, nullptr, nullptr, nullptr, hh, wh}, B, s);
    launch<T, 4 * b, kGates, kConv>(
        ConvArgs{c2, 2 * b, h2, 2 * b, hh, wh, wt[6], wt[7], rh2, ug2, h2, nullptr, hh, wh}, B, s);
    launch<T, 2 * b, kCand, kConv>(
        ConvArgs{c2, 2 * b, rh2, 2 * b, hh, wh, wt[8], wt[9], nullptr, nullptr, h2, ug2, hh, wh}, B, s);
    launch<T, b, kSkipRelu, kDeconvStride2>(
        ConvArgs{h2, 2 * b, nullptr, 0, hh, wh, wt[10], wt[11], u1, nullptr, nullptr, h1, h, w}, B, s);
    if (up)
      launch<T, 1, kBias, kDeconvStride2>(
          ConvArgs{u1, b, nullptr, 0, h, w, wt[12], wt[13], out, nullptr, nullptr, nullptr, oh, ow}, B, s);
    else
      launch<T, 1, kBias, kConv>(
          ConvArgs{u1, b, nullptr, 0, h, w, wt[12], wt[13], out, nullptr, nullptr, nullptr, oh, ow}, B, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T>
int run_base(int base, int cin, int up, int D, int B, int h, int w, const void* vol,
             const float* const* wt, void* cost, void* scratch, cudaStream_t s) {
  const T* v = static_cast<const T*>(vol);
  T* c = static_cast<T*>(cost);
  T* sc = static_cast<T*>(scratch);
  switch (base) {
    case 4: return run<T, 4>(cin, up, D, B, h, w, v, wt, c, sc, s);
    case 8: return run<T, 8>(cin, up, D, B, h, w, v, wt, c, sc, s);
    default: return adamvs::kBadBase;
  }
}

}  // namespace

// K3: the whole recurrence of one stage. Returns 0 or the first launch error.
extern "C" int adamvs_red_scan(int dtype, int base, int cin, int up, int D, int B, int h, int w,
                               const void* vol, const void* wc1, const void* wg1, const void* bg1,
                               const void* wn1, const void* bn1, const void* wc2, const void* wg2,
                               const void* bg2, const void* wn2, const void* bn2, const void* wu1,
                               const void* bu1, const void* wh, const void* bh, void* cost,
                               void* scratch, void* stream) {
  const float* wt[14] = {
      static_cast<const float*>(wc1), static_cast<const float*>(wg1),
      static_cast<const float*>(bg1), static_cast<const float*>(wn1),
      static_cast<const float*>(bn1), static_cast<const float*>(wc2),
      static_cast<const float*>(wg2), static_cast<const float*>(bg2),
      static_cast<const float*>(wn2), static_cast<const float*>(bn2),
      static_cast<const float*>(wu1), static_cast<const float*>(bu1),
      static_cast<const float*>(wh), static_cast<const float*>(bh)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == adamvs::kFloat32) return run_base<float>(base, cin, up, D, B, h, w, vol, wt, cost, scratch, s);
  if (dtype == adamvs::kBFloat16)
    return run_base<__nv_bfloat16>(base, cin, up, D, B, h, w, vol, wt, cost, scratch, s);
  return adamvs::kBadDtype;
}
