/* mvsnative — native host-side runtime for adamvs_tpu_torch.
 *
 * The reference feeds its GPU from single-worker Python (PIL/cv2 decode,
 * numpy normalization — train_whu.py:85-86, preprocess.py:102-112). At GPU
 * inference rates the host becomes the bottleneck, so the decode/normalize
 * path is native: zlib-based PNG and OpenEXR scanline decoders plus
 * OpenMP-parallel preprocessing, exposed through a C ABI consumed from
 * Python via ctypes (adamvs_tpu_torch/io/native.py), built with g++ at first
 * use by adamvs_tpu_torch/kernels/build.py::build_host.
 */
#ifndef MVSNATIVE_H
#define MVSNATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- PNG ----
 * Supports 8/16-bit, gray / RGB / palette / gray+alpha / RGBA, all filter
 * types, non-interlaced. 16-bit samples are returned host-endian.
 * Returns 0 on success, negative error code otherwise. */
int mvs_png_info(const uint8_t *data, size_t size, int32_t *width,
                 int32_t *height, int32_t *channels, int32_t *bit_depth);
int mvs_png_decode(const uint8_t *data, size_t size, void *out);

/* ---- EXR (scanline, NONE/ZIPS/ZIP, HALF/FLOAT/UINT) ----
 * Single-channel read of the alphabetically-first of Z/Y/R/first channel,
 * converted to float32. */
int mvs_exr_info(const uint8_t *data, size_t size, int32_t *width,
                 int32_t *height);
int mvs_exr_read_depth(const uint8_t *data, size_t size, float *out);

/* ---- preprocessing ---- */
/* Per-image mean/var normalization (preprocess.py:102-112):
 * out = (img - mean) / (sqrt(var) + 1e-8), statistics per channel. */
void mvs_center_image_u8(const uint8_t *img, int32_t h, int32_t w, int32_t c,
                         float *out);

/* Bilinear resize (half-pixel centers, matches cv2.INTER_LINEAR) of an
 * interleaved uint8 image. */
void mvs_resize_bilinear_u8(const uint8_t *src, int32_t sh, int32_t sw,
                            int32_t c, uint8_t *dst, int32_t dh, int32_t dw);

/* version/availability probe */
int mvs_native_version(void);

#ifdef __cplusplus
}
#endif

#endif /* MVSNATIVE_H */
