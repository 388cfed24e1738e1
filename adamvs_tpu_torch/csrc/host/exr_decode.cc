// OpenEXR scanline decoder: v2, INCREASING_Y, NONE/ZIPS/ZIP compression,
// HALF/FLOAT/UINT channels. Chunk inflation is OpenMP-parallel (chunks are
// independent). Mirrors the Python codec in adamvs_tpu_torch/io/exr.py; bound by
// adamvs_tpu_torch/io/native.py::read_exr_depth.

#include "mvsnative.h"

#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int32_t kMagic = 20000630;

struct Channel {
  std::string name;
  int pixel_type;  // 0 UINT, 1 HALF, 2 FLOAT
};

struct ExrHeader {
  std::vector<Channel> channels;
  int compression = 0;
  int32_t xmin = 0, ymin = 0, xmax = 0, ymax = 0;
  size_t data_offset = 0;  // first byte after line-offset table
  int32_t width() const { return xmax - xmin + 1; }
  int32_t height() const { return ymax - ymin + 1; }
  int lines_per_block() const { return compression == 3 ? 16 : 1; }
};

int32_t rd32(const uint8_t *p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3ff;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

int parse_header(const uint8_t *data, size_t size, ExrHeader *h) {
  if (size < 16 || rd32(data) != kMagic) return -1;
  if (rd32(data + 4) & 0x200) return -2;  // tiled
  size_t pos = 8;
  auto cstr = [&](std::string *out) -> bool {
    size_t start = pos;
    while (pos < size && data[pos] != 0) pos++;
    if (pos >= size) return false;
    out->assign((const char *)data + start, pos - start);
    pos++;
    return true;
  };
  while (true) {
    std::string name, type;
    if (!cstr(&name)) return -3;
    if (name.empty()) break;
    if (!cstr(&type)) return -3;
    if (pos + 4 > size) return -3;
    int32_t attr_size = rd32(data + pos);
    pos += 4;
    if (pos + (size_t)attr_size > size) return -3;
    const uint8_t *payload = data + pos;
    if (name == "channels") {
      size_t cp = 0;
      while (payload[cp] != 0) {
        Channel ch;
        size_t s = cp;
        while (cp < (size_t)attr_size && payload[cp] != 0) cp++;
        ch.name.assign((const char *)payload + s, cp - s);
        cp++;  // nul
        ch.pixel_type = rd32(payload + cp);
        cp += 16;  // type + pLinear/reserved + samplings
        h->channels.push_back(ch);
      }
    } else if (name == "compression") {
      h->compression = payload[0];
    } else if (name == "dataWindow") {
      h->xmin = rd32(payload);
      h->ymin = rd32(payload + 4);
      h->xmax = rd32(payload + 8);
      h->ymax = rd32(payload + 12);
    }
    pos += attr_size;
  }
  if (h->compression != 0 && h->compression != 2 && h->compression != 3)
    return -4;
  int num_chunks =
      (h->height() + h->lines_per_block() - 1) / h->lines_per_block();
  h->data_offset = pos + 8 * (size_t)num_chunks;
  if (h->data_offset > size) return -3;
  return 0;
}

// EXR zip post-inflate reconstruction: undo predictor then de-interleave.
void zip_reconstruct(uint8_t *buf, size_t n, uint8_t *scratch) {
  for (size_t i = 1; i < n; ++i) buf[i] = (uint8_t)(buf[i - 1] + buf[i] - 128);
  size_t half = (n + 1) / 2;
  const uint8_t *t1 = buf, *t2 = buf + half;
  for (size_t i = 0; i < half; ++i) scratch[2 * i] = t1[i];
  for (size_t i = 0; i < n - half; ++i) scratch[2 * i + 1] = t2[i];
  std::memcpy(buf, scratch, n);
}

}  // namespace

extern "C" int mvs_exr_info(const uint8_t *data, size_t size, int32_t *width,
                            int32_t *height) {
  ExrHeader h;
  int rc = parse_header(data, size, &h);
  if (rc) return rc;
  *width = h.width();
  *height = h.height();
  return 0;
}

extern "C" int mvs_exr_read_depth(const uint8_t *data, size_t size,
                                  float *out) {
  ExrHeader h;
  int rc = parse_header(data, size, &h);
  if (rc) return rc;
  const int32_t W = h.width(), H = h.height();
  // channel preference: Z, Y, R, else first (channels are name-sorted on disk)
  int want = -1;
  for (const char *pref : {"Z", "Y", "R"}) {
    for (size_t i = 0; i < h.channels.size(); ++i)
      if (h.channels[i].name == pref) {
        want = (int)i;
        break;
      }
    if (want >= 0) break;
  }
  if (want < 0) want = 0;

  size_t bytes_per_px = 0;
  std::vector<size_t> ch_size(h.channels.size());
  for (size_t i = 0; i < h.channels.size(); ++i) {
    ch_size[i] = h.channels[i].pixel_type == 1 ? 2 : 4;
    bytes_per_px += ch_size[i];
  }
  size_t line_bytes = bytes_per_px * (size_t)W;
  int lpb = h.lines_per_block();
  int num_chunks = (H + lpb - 1) / lpb;

  // index chunk extents sequentially (offset table is validated implicitly)
  struct ChunkRef {
    int32_t y;
    const uint8_t *data;
    size_t size;
  };
  std::vector<ChunkRef> chunks;
  chunks.reserve(num_chunks);
  size_t pos = h.data_offset;
  for (int c = 0; c < num_chunks; ++c) {
    if (pos + 8 > size) return -5;
    int32_t y = rd32(data + pos);
    int32_t csize = rd32(data + pos + 4);
    pos += 8;
    if (pos + (size_t)csize > size) return -5;
    chunks.push_back({y, data + pos, (size_t)csize});
    pos += csize;
  }

  int err = 0;
#pragma omp parallel for schedule(dynamic)
  for (int c = 0; c < num_chunks; ++c) {
    int32_t y0 = chunks[c].y - h.ymin;
    int nlines = lpb < H - y0 ? lpb : H - y0;
    size_t expect = line_bytes * (size_t)nlines;
    std::vector<uint8_t> buf(expect), scratch(expect);
    const uint8_t *chunk = chunks[c].data;
    if (h.compression != 0 && chunks[c].size < expect) {
      uLongf dst_len = (uLongf)expect;
      if (uncompress(buf.data(), &dst_len, chunk, (uLong)chunks[c].size) !=
              Z_OK ||
          dst_len != expect) {
        err = -6;
        continue;
      }
      zip_reconstruct(buf.data(), expect, scratch.data());
      chunk = buf.data();
    }
    for (int line = 0; line < nlines; ++line) {
      const uint8_t *p = chunk + line_bytes * (size_t)line;
      // channels stored name-sorted, each a full row
      for (size_t ci = 0; ci < h.channels.size(); ++ci) {
        if ((int)ci == want) {
          float *o = out + ((size_t)(y0 + line)) * W;
          int pt = h.channels[ci].pixel_type;
          if (pt == 2) {
            std::memcpy(o, p, 4 * (size_t)W);
          } else if (pt == 1) {
            const uint16_t *hp = (const uint16_t *)p;
            for (int32_t x = 0; x < W; ++x) o[x] = half_to_float(hp[x]);
          } else {  // UINT
            const uint32_t *up = (const uint32_t *)p;
            for (int32_t x = 0; x < W; ++x) o[x] = (float)up[x];
          }
        }
        p += ch_size[ci] * (size_t)W;
      }
    }
  }
  return err;
}
