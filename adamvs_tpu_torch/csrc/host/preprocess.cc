// OpenMP-parallel host preprocessing: per-image normalization and bilinear
// resize, matching the Python pipeline semantics
// (adamvs_tpu_torch/data/pipeline.py::center_image, cv2.INTER_LINEAR); bound by
// adamvs_tpu_torch/io/native.py::center_image and resize_bilinear.

#include "mvsnative.h"

#include <cmath>
#include <cstring>
#include <vector>

extern "C" void mvs_center_image_u8(const uint8_t *img, int32_t h, int32_t w,
                                    int32_t c, float *out) {
  const size_t n = (size_t)h * w;
  std::vector<double> sum(c, 0.0), sumsq(c, 0.0);
#pragma omp parallel
  {
    std::vector<double> lsum(c, 0.0), lsq(c, 0.0);
#pragma omp for nowait
    for (long long i = 0; i < (long long)n; ++i) {
      const uint8_t *p = img + (size_t)i * c;
      for (int32_t k = 0; k < c; ++k) {
        double v = p[k];
        lsum[k] += v;
        lsq[k] += v * v;
      }
    }
#pragma omp critical
    for (int32_t k = 0; k < c; ++k) {
      sum[k] += lsum[k];
      sumsq[k] += lsq[k];
    }
  }
  std::vector<float> mean(c), inv(c);
  for (int32_t k = 0; k < c; ++k) {
    double m = sum[k] / (double)n;
    double var = sumsq[k] / (double)n - m * m;
    if (var < 0) var = 0;
    mean[k] = (float)m;
    inv[k] = (float)(1.0 / (std::sqrt(var) + 1e-8));
  }
#pragma omp parallel for
  for (long long i = 0; i < (long long)n; ++i) {
    const uint8_t *p = img + (size_t)i * c;
    float *o = out + (size_t)i * c;
    for (int32_t k = 0; k < c; ++k) o[k] = ((float)p[k] - mean[k]) * inv[k];
  }
}

extern "C" void mvs_resize_bilinear_u8(const uint8_t *src, int32_t sh,
                                       int32_t sw, int32_t c, uint8_t *dst,
                                       int32_t dh, int32_t dw) {
  const float sy = (float)sh / dh;
  const float sx = (float)sw / dw;
#pragma omp parallel for schedule(static)
  for (int32_t y = 0; y < dh; ++y) {
    float fy = ((float)y + 0.5f) * sy - 0.5f;
    int32_t y0 = (int32_t)std::floor(fy);
    float wy = fy - y0;
    int32_t y0c = y0 < 0 ? 0 : (y0 > sh - 1 ? sh - 1 : y0);
    int32_t y1c = y0 + 1 < 0 ? 0 : (y0 + 1 > sh - 1 ? sh - 1 : y0 + 1);
    const uint8_t *r0 = src + (size_t)y0c * sw * c;
    const uint8_t *r1 = src + (size_t)y1c * sw * c;
    uint8_t *orow = dst + (size_t)y * dw * c;
    for (int32_t x = 0; x < dw; ++x) {
      float fx = ((float)x + 0.5f) * sx - 0.5f;
      int32_t x0 = (int32_t)std::floor(fx);
      float wx = fx - x0;
      int32_t x0c = x0 < 0 ? 0 : (x0 > sw - 1 ? sw - 1 : x0);
      int32_t x1c = x0 + 1 < 0 ? 0 : (x0 + 1 > sw - 1 ? sw - 1 : x0 + 1);
      for (int32_t k = 0; k < c; ++k) {
        float a = r0[x0c * c + k] * (1 - wx) + r0[x1c * c + k] * wx;
        float b = r1[x0c * c + k] * (1 - wx) + r1[x1c * c + k] * wx;
        float v = a * (1 - wy) + b * wy;
        int iv = (int)(v + 0.5f);
        orow[x * c + k] = (uint8_t)(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
      }
    }
  }
}

extern "C" int mvs_native_version(void) { return 1; }
