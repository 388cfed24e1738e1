// PNG decoder (zlib inflate + unfiltering). Non-interlaced 8/16-bit images,
// color types 0/2/3/4/6. Format: RFC 2083. Bound by
// adamvs_tpu_torch/io/native.py::decode_png.

#include "mvsnative.h"

#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

constexpr uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngHeader {
  int32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  int channels = 0;
};

int parse_header(const uint8_t *data, size_t size, PngHeader *h) {
  if (size < 8 + 25 || std::memcmp(data, kSig, 8) != 0) return -1;
  const uint8_t *p = data + 8;
  if (be32(p) != 13 || std::memcmp(p + 4, "IHDR", 4) != 0) return -2;
  h->width = (int32_t)be32(p + 8);
  h->height = (int32_t)be32(p + 12);
  h->bit_depth = p[16];
  h->color_type = p[17];
  h->interlace = p[20];
  if (h->interlace != 0) return -3;  // Adam7 unsupported
  switch (h->color_type) {
    case 0: h->channels = 1; break;
    case 2: h->channels = 3; break;
    case 3: h->channels = 3; break;  // palette expands to RGB
    case 4: h->channels = 2; break;
    case 6: h->channels = 4; break;
    default: return -4;
  }
  if (h->bit_depth != 8 && h->bit_depth != 16) return -5;  // <8bpp unsupported
  if (h->color_type == 3 && h->bit_depth != 8) return -5;
  return 0;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" int mvs_png_info(const uint8_t *data, size_t size, int32_t *width,
                            int32_t *height, int32_t *channels,
                            int32_t *bit_depth) {
  PngHeader h;
  int rc = parse_header(data, size, &h);
  if (rc) return rc;
  *width = h.width;
  *height = h.height;
  *channels = h.channels;
  *bit_depth = h.bit_depth;
  return 0;
}

extern "C" int mvs_png_decode(const uint8_t *data, size_t size, void *out) {
  PngHeader h;
  int rc = parse_header(data, size, &h);
  if (rc) return rc;

  // walk chunks: collect IDAT, PLTE
  std::vector<uint8_t> idat;
  const uint8_t *plte = nullptr;
  size_t plte_entries = 0;
  size_t pos = 8;
  while (pos + 12 <= size) {
    uint32_t len = be32(data + pos);
    const uint8_t *type = data + pos + 4;
    const uint8_t *payload = data + pos + 8;
    if (pos + 12 + len > size) return -6;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      plte = payload;
      plte_entries = len / 3;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (idat.empty()) return -7;
  if (h.color_type == 3 && !plte) return -8;

  // raw channel count in the stream (palette rows store indices)
  int stream_ch = h.color_type == 3 ? 1 : h.channels;
  size_t bytes_per_sample = h.bit_depth / 8;
  size_t bpp = (size_t)stream_ch * bytes_per_sample;  // filter unit
  size_t row_bytes = (size_t)h.width * bpp;
  size_t raw_size = (row_bytes + 1) * (size_t)h.height;

  std::vector<uint8_t> raw(raw_size);
  {
    z_stream zs{};
    if (inflateInit(&zs) != Z_OK) return -9;
    zs.next_in = idat.data();
    zs.avail_in = (uInt)idat.size();
    zs.next_out = raw.data();
    zs.avail_out = (uInt)raw.size();
    int zrc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (zrc != Z_STREAM_END && !(zrc == Z_OK && zs.avail_out == 0)) return -10;
  }

  // unfilter in place (sequential: rows depend on the previous row)
  std::vector<uint8_t> prev(row_bytes, 0);
  uint8_t *dst8 = (uint8_t *)out;
  uint16_t *dst16 = (uint16_t *)out;

  std::vector<uint8_t> cur(row_bytes);
  for (int32_t y = 0; y < h.height; ++y) {
    const uint8_t *src = raw.data() + (size_t)y * (row_bytes + 1);
    uint8_t filter = src[0];
    std::memcpy(cur.data(), src + 1, row_bytes);
    switch (filter) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < row_bytes; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < row_bytes; ++i) cur[i] += prev[i];
        break;
      case 3:
        for (size_t i = 0; i < bpp; ++i) cur[i] += prev[i] / 2;
        for (size_t i = bpp; i < row_bytes; ++i)
          cur[i] += (uint8_t)(((int)cur[i - bpp] + (int)prev[i]) / 2);
        break;
      case 4:
        for (size_t i = 0; i < bpp; ++i)
          cur[i] += (uint8_t)paeth(0, prev[i], 0);
        for (size_t i = bpp; i < row_bytes; ++i)
          cur[i] += (uint8_t)paeth(cur[i - bpp], prev[i], prev[i - bpp]);
        break;
      default:
        return -11;
    }

    // emit row
    if (h.color_type == 3) {
      uint8_t *o = dst8 + (size_t)y * h.width * 3;
      for (int32_t x = 0; x < h.width; ++x) {
        uint8_t idx = cur[x];
        if (idx >= plte_entries) return -12;
        o[3 * x + 0] = plte[3 * idx + 0];
        o[3 * x + 1] = plte[3 * idx + 1];
        o[3 * x + 2] = plte[3 * idx + 2];
      }
    } else if (h.bit_depth == 8) {
      std::memcpy(dst8 + (size_t)y * row_bytes, cur.data(), row_bytes);
    } else {  // 16-bit big-endian -> host
      uint16_t *o = dst16 + (size_t)y * h.width * stream_ch;
      for (size_t i = 0; i < row_bytes; i += 2)
        o[i / 2] = (uint16_t)((cur[i] << 8) | cur[i + 1]);
    }
    std::swap(prev, cur);
  }
  return 0;
}
