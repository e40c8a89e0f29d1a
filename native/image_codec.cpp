// Native image codec: PGM/PPM (binary + ascii), PFM (float), BMP (8/24/32),
// PNG (8-bit gray/RGB/RGBA/palette, non-interlaced, via zlib inflate).
//
// Native replacement for the IO role OpenCV plays in the reference
// (`cv::imread` at /root/reference/src/CameraStereoVision.cpp:16; the
// framework contract asks for a native runtime around the XLA compute path).
// Exposed through the C API in loader.cpp; Python binds via ctypes
// (stereovisionarray_tpu/datasets/native_loader.py).
//
// All decoders produce float32 grayscale (luma 0..255) or float32 RGB
// interleaved, caller-selected; decode errors return false and set a
// thread-local message retrievable via svt_last_error().

#include "image_codec.h"

#include <zlib.h>

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

namespace svt {

thread_local std::string g_last_error;

static bool fail(const std::string& msg) {
  g_last_error = msg;
  return false;
}

static bool read_file(const std::string& path, std::vector<uint8_t>* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return fail("cannot open " + path);
  f.seekg(0, std::ios::end);
  std::streamoff n = f.tellg();
  f.seekg(0, std::ios::beg);
  out->resize(static_cast<size_t>(n));
  f.read(reinterpret_cast<char*>(out->data()), n);
  return f.good() || f.eof();
}

// ---------------------------------------------------------------------
// PNM family (P2/P3/P5/P6) + PFM (Pf/PF)
// ---------------------------------------------------------------------
namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
};

void skip_ws_comments(Cursor* c) {
  while (c->p < c->end) {
    if (std::isspace(*c->p)) {
      ++c->p;
    } else if (*c->p == '#') {
      while (c->p < c->end && *c->p != '\n') ++c->p;
    } else {
      break;
    }
  }
}

bool parse_int(Cursor* c, long* out) {
  skip_ws_comments(c);
  if (c->p >= c->end || !std::isdigit(*c->p)) return false;
  long v = 0;
  while (c->p < c->end && std::isdigit(*c->p)) v = v * 10 + (*c->p++ - '0');
  *out = v;
  return true;
}

bool parse_float(Cursor* c, double* out) {
  skip_ws_comments(c);
  char buf[64];
  size_t i = 0;
  while (c->p < c->end && !std::isspace(*c->p) && i + 1 < sizeof(buf)) buf[i++] = *c->p++;
  buf[i] = 0;
  if (i == 0) return false;
  *out = std::strtod(buf, nullptr);
  return true;
}

}  // namespace

static bool decode_pnm(const std::vector<uint8_t>& data, Image* out) {
  if (data.size() < 2) return fail("pnm: truncated");
  char kind = static_cast<char>(data[1]);
  Cursor c{data.data() + 2, data.data() + data.size()};

  if (kind == 'f' || kind == 'F') {  // PFM: gray or RGB float
    long w, h;
    double scale;
    if (!parse_int(&c, &w) || !parse_int(&c, &h) || !parse_float(&c, &scale))
      return fail("pfm: bad header");
    if (w <= 0 || h <= 0 || w > 1 << 20 || h > 1 << 20) return fail("pfm: bad dims");
    ++c.p;  // single whitespace after scale
    int ch = (kind == 'F') ? 3 : 1;
    size_t need = static_cast<size_t>(w) * h * ch * 4;
    if (static_cast<size_t>(c.end - c.p) < need) return fail("pfm: truncated data");
    out->width = static_cast<int>(w);
    out->height = static_cast<int>(h);
    out->channels = ch;
    out->pixels.resize(static_cast<size_t>(w) * h * ch);
    bool little = scale < 0.0;
    // PFM scanlines are bottom-to-top
    for (long row = 0; row < h; ++row) {
      const uint8_t* src = c.p + static_cast<size_t>(h - 1 - row) * w * ch * 4;
      float* dst = out->pixels.data() + static_cast<size_t>(row) * w * ch;
      if (little) {
        std::memcpy(dst, src, static_cast<size_t>(w) * ch * 4);
      } else {
        for (long i = 0; i < w * ch; ++i) {
          uint8_t b[4] = {src[i * 4 + 3], src[i * 4 + 2], src[i * 4 + 1], src[i * 4]};
          std::memcpy(dst + i, b, 4);
        }
      }
    }
    return true;
  }

  int ch = (kind == '3' || kind == '6') ? 3 : 1;
  bool ascii = (kind == '2' || kind == '3');
  if (!ascii && kind != '5' && kind != '6') return fail("pnm: unsupported type");
  long w, h, maxv;
  if (!parse_int(&c, &w) || !parse_int(&c, &h) || !parse_int(&c, &maxv))
    return fail("pnm: bad header");
  if (w <= 0 || h <= 0 || w > 1 << 20 || h > 1 << 20) return fail("pnm: bad dims");
  if (maxv <= 0 || maxv > 65535) return fail("pnm: bad maxval");
  out->width = static_cast<int>(w);
  out->height = static_cast<int>(h);
  out->channels = ch;
  out->pixels.resize(static_cast<size_t>(w) * h * ch);
  float norm = 255.0f / static_cast<float>(maxv);
  size_t count = static_cast<size_t>(w) * h * ch;
  if (ascii) {
    for (size_t i = 0; i < count; ++i) {
      long v;
      if (!parse_int(&c, &v)) return fail("pnm: truncated ascii data");
      out->pixels[i] = static_cast<float>(v) * norm;
    }
  } else {
    ++c.p;  // single whitespace after maxval
    int bytes = maxv > 255 ? 2 : 1;
    if (static_cast<size_t>(c.end - c.p) < count * bytes) return fail("pnm: truncated data");
    if (bytes == 1) {
      for (size_t i = 0; i < count; ++i) out->pixels[i] = c.p[i] * norm;
    } else {
      for (size_t i = 0; i < count; ++i) {
        uint16_t v = static_cast<uint16_t>((c.p[i * 2] << 8) | c.p[i * 2 + 1]);
        out->pixels[i] = v * norm;
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------
// BMP (uncompressed 8-bit palette / 24 / 32 bpp)
// ---------------------------------------------------------------------
static uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (p[1] << 8) | (p[2] << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
static uint16_t rd16(const uint8_t* p) { return static_cast<uint16_t>(p[0] | (p[1] << 8)); }

static bool decode_bmp(const std::vector<uint8_t>& d, Image* out) {
  if (d.size() < 54) return fail("bmp: truncated header");
  uint32_t data_off = rd32(&d[10]);
  uint32_t hdr_size = rd32(&d[14]);
  if (hdr_size < 40) return fail("bmp: unsupported header");
  int32_t w = static_cast<int32_t>(rd32(&d[18]));
  int32_t h = static_cast<int32_t>(rd32(&d[22]));
  bool topdown = h < 0;
  if (topdown) h = -h;
  uint16_t bpp = rd16(&d[28]);
  uint32_t comp = rd32(&d[30]);
  if (comp != 0 && !(comp == 3 && bpp == 32)) return fail("bmp: compressed unsupported");
  if (w <= 0 || h <= 0 || w > 1 << 20 || h > 1 << 20) return fail("bmp: bad dims");
  if (bpp != 8 && bpp != 24 && bpp != 32) return fail("bmp: bpp unsupported");

  const uint8_t* pal = nullptr;
  if (bpp == 8) {
    // the 256-entry BGRA palette must fit between the header and pixel data
    size_t pal_off = 14 + static_cast<size_t>(hdr_size);
    if (pal_off + 256 * 4 > d.size() || pal_off + 256 * 4 > data_off)
      return fail("bmp: truncated palette");
    pal = &d[pal_off];
  }
  size_t stride = (static_cast<size_t>(w) * bpp / 8 + 3) & ~size_t{3};
  if (data_off > d.size() || d.size() - data_off < stride * h)
    return fail("bmp: truncated data");

  out->width = w;
  out->height = h;
  out->channels = 3;
  out->pixels.resize(static_cast<size_t>(w) * h * 3);
  for (int32_t row = 0; row < h; ++row) {
    const uint8_t* src = &d[data_off + stride * (topdown ? row : (h - 1 - row))];
    float* dst = out->pixels.data() + static_cast<size_t>(row) * w * 3;
    for (int32_t x = 0; x < w; ++x) {
      uint8_t r, g, b;
      if (bpp == 8) {
        const uint8_t* e = pal + src[x] * 4;
        b = e[0]; g = e[1]; r = e[2];
      } else {
        const uint8_t* px = src + x * (bpp / 8);
        b = px[0]; g = px[1]; r = px[2];
      }
      dst[x * 3 + 0] = r;
      dst[x * 3 + 1] = g;
      dst[x * 3 + 2] = b;
    }
  }
  return true;
}

// ---------------------------------------------------------------------
// PNG: 8-bit depth, color types 0 (gray), 2 (RGB), 3 (palette), 4 (gray+A),
// 6 (RGBA); non-interlaced. Inflate via zlib, then per-scanline defilter.
// ---------------------------------------------------------------------
static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

static bool decode_png(const std::vector<uint8_t>& d, Image* out) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (d.size() < 8 || std::memcmp(d.data(), magic, 8) != 0) return fail("png: bad magic");

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // rgb triples
  std::vector<uint8_t> trns;

  size_t pos = 8;
  while (pos + 8 <= d.size()) {
    uint32_t len = (d[pos] << 24) | (d[pos + 1] << 16) | (d[pos + 2] << 8) | d[pos + 3];
    const char* type = reinterpret_cast<const char*>(&d[pos + 4]);
    if (pos + 12 + len > d.size()) return fail("png: truncated chunk");
    const uint8_t* body = &d[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return fail("png: bad IHDR");
      w = (body[0] << 24) | (body[1] << 16) | (body[2] << 8) | body[3];
      h = (body[4] << 24) | (body[5] << 16) | (body[6] << 8) | body[7];
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      palette.assign(body, body + len);
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      trns.assign(body, body + len);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w == 0 || h == 0) return fail("png: no IHDR");
  if (w > 1u << 20 || h > 1u << 20) return fail("png: bad dims");
  if (interlace != 0) return fail("png: interlaced unsupported");
  if (bit_depth != 8 && bit_depth != 16) return fail("png: bit depth unsupported");
  int src_ch;
  switch (color_type) {
    case 0: src_ch = 1; break;
    case 2: src_ch = 3; break;
    case 3: src_ch = 1; break;
    case 4: src_ch = 2; break;
    case 6: src_ch = 4; break;
    default: return fail("png: color type unsupported");
  }
  if (color_type == 3 && bit_depth != 8) return fail("png: palette depth unsupported");

  int bypp = src_ch * (bit_depth / 8);  // bytes per pixel
  size_t stride = static_cast<size_t>(w) * bypp;
  std::vector<uint8_t> raw(static_cast<size_t>(h) * (stride + 1));
  uLongf raw_len = raw.size();
  int zrc = uncompress(raw.data(), &raw_len, idat.data(), idat.size());
  if (zrc != Z_OK || raw_len != raw.size()) return fail("png: inflate failed");

  // defilter in place into `img` rows
  std::vector<uint8_t> img(static_cast<size_t>(h) * stride);
  for (uint32_t row = 0; row < h; ++row) {
    uint8_t filter = raw[row * (stride + 1)];
    const uint8_t* src = &raw[row * (stride + 1) + 1];
    uint8_t* cur = &img[row * stride];
    const uint8_t* up = row ? &img[(row - 1) * stride] : nullptr;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= static_cast<size_t>(bypp) ? cur[i - bypp] : 0;
      int b = up ? up[i] : 0;
      int cc = (up && i >= static_cast<size_t>(bypp)) ? up[i - bypp] : 0;
      int x = src[i];
      switch (filter) {
        case 0: cur[i] = static_cast<uint8_t>(x); break;
        case 1: cur[i] = static_cast<uint8_t>(x + a); break;
        case 2: cur[i] = static_cast<uint8_t>(x + b); break;
        case 3: cur[i] = static_cast<uint8_t>(x + ((a + b) >> 1)); break;
        case 4: cur[i] = static_cast<uint8_t>(x + paeth(a, b, cc)); break;
        default: return fail("png: bad filter");
      }
    }
  }

  out->width = static_cast<int>(w);
  out->height = static_cast<int>(h);
  out->channels = (color_type == 0 || color_type == 4) ? 1 : 3;
  out->pixels.resize(static_cast<size_t>(w) * h * out->channels);
  float norm = bit_depth == 16 ? 255.0f / 65535.0f : 1.0f;
  for (uint32_t row = 0; row < h; ++row) {
    const uint8_t* src = &img[row * stride];
    float* dst = out->pixels.data() + static_cast<size_t>(row) * w * out->channels;
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t* px = src + static_cast<size_t>(x) * bypp;
      auto sample = [&](int ci) -> float {
        if (bit_depth == 16) {
          return static_cast<float>((px[ci * 2] << 8) | px[ci * 2 + 1]) * norm;
        }
        return static_cast<float>(px[ci]);
      };
      if (color_type == 3) {
        uint8_t idx = px[0];
        if (static_cast<size_t>(idx) * 3 + 2 >= palette.size()) return fail("png: palette oob");
        dst[x * 3 + 0] = palette[idx * 3 + 0];
        dst[x * 3 + 1] = palette[idx * 3 + 1];
        dst[x * 3 + 2] = palette[idx * 3 + 2];
      } else if (out->channels == 1) {
        dst[x] = sample(0);
      } else {
        dst[x * 3 + 0] = sample(0);
        dst[x * 3 + 1] = sample(1);
        dst[x * 3 + 2] = sample(2);
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------
bool decode_image(const std::string& path, Image* out) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data)) return false;
  if (data.size() < 2) return fail("empty file " + path);
  if (data[0] == 'P') return decode_pnm(data, out);
  if (data[0] == 'B' && data[1] == 'M') return decode_bmp(data, out);
  if (data[0] == 137 && data[1] == 'P') return decode_png(data, out);
  return fail("unknown format " + path);
}

void to_gray(const Image& in, std::vector<float>* out) {
  size_t n = static_cast<size_t>(in.width) * in.height;
  out->resize(n);
  if (in.channels == 1) {
    std::memcpy(out->data(), in.pixels.data(), n * 4);
  } else {
    for (size_t i = 0; i < n; ++i) {
      const float* p = &in.pixels[i * 3];
      (*out)[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
    }
  }
}

void decimate2(std::vector<float>* px, int* w, int* h, int channels) {
  int nw = *w / 2, nh = *h / 2;
  // strided top-left pick, matching the reference's cv::resize-free 0.5x
  // ingest role (/root/reference/src/CameraStereoVision.cpp:18)
  std::vector<float> out(static_cast<size_t>(nw) * nh * channels);
  for (int y = 0; y < nh; ++y)
    for (int x = 0; x < nw; ++x)
      for (int c = 0; c < channels; ++c)
        out[(static_cast<size_t>(y) * nw + x) * channels + c] =
            (*px)[(static_cast<size_t>(y) * 2 * (*w) + x * 2) * channels + c];
  *px = std::move(out);
  *w = nw;
  *h = nh;
}

}  // namespace svt

namespace svt {

// ---------------------------------------------------------------------
// Minimal PNG encoder: 8-bit grayscale, filter 0, one IDAT chunk.
// The write-side counterpart of decode_png — completes the native IO
// runtime so artifact export (datasets/io.py save_png) needs no Python
// imaging dependency.
// ---------------------------------------------------------------------
namespace {

uint32_t crc32_of(const uint8_t* a, size_t n, uint32_t crc = 0xFFFFFFFFu) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  for (size_t i = 0; i < n; ++i) crc = table[(crc ^ a[i]) & 0xFF] ^ (crc >> 8);
  return crc;
}

void put32(std::vector<uint8_t>* v, uint32_t x) {
  v->push_back(static_cast<uint8_t>(x >> 24));
  v->push_back(static_cast<uint8_t>(x >> 16));
  v->push_back(static_cast<uint8_t>(x >> 8));
  v->push_back(static_cast<uint8_t>(x));
}

void chunk(std::vector<uint8_t>* out, const char type[4],
           const std::vector<uint8_t>& body) {
  put32(out, static_cast<uint32_t>(body.size()));
  size_t start = out->size();
  out->insert(out->end(), type, type + 4);
  out->insert(out->end(), body.begin(), body.end());
  uint32_t crc = crc32_of(out->data() + start, out->size() - start) ^ 0xFFFFFFFFu;
  put32(out, crc);
}

}  // namespace

bool encode_png_gray(const std::string& path, const unsigned char* data,
                     int width, int height) {
  if (width <= 0 || height <= 0) return fail("png encode: bad dims");
  // raw scanlines with filter byte 0
  std::vector<uint8_t> raw(static_cast<size_t>(height) * (width + 1));
  for (int y = 0; y < height; ++y) {
    raw[static_cast<size_t>(y) * (width + 1)] = 0;
    std::memcpy(&raw[static_cast<size_t>(y) * (width + 1) + 1],
                data + static_cast<size_t>(y) * width, width);
  }
  uLongf zcap = compressBound(raw.size());
  std::vector<uint8_t> z(zcap);
  if (compress2(z.data(), &zcap, raw.data(), raw.size(), 6) != Z_OK)
    return fail("png encode: deflate failed");
  z.resize(zcap);

  std::vector<uint8_t> out;
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.insert(out.end(), magic, magic + 8);
  std::vector<uint8_t> ihdr;
  put32(&ihdr, static_cast<uint32_t>(width));
  put32(&ihdr, static_cast<uint32_t>(height));
  ihdr.push_back(8);   // bit depth
  ihdr.push_back(0);   // color type: gray
  ihdr.push_back(0);   // compression
  ihdr.push_back(0);   // filter
  ihdr.push_back(0);   // interlace
  chunk(&out, "IHDR", ihdr);
  chunk(&out, "IDAT", z);
  chunk(&out, "IEND", {});

  std::ofstream f(path, std::ios::binary);
  if (!f) return fail("png encode: cannot open " + path);
  f.write(reinterpret_cast<const char*>(out.data()), out.size());
  return f.good();
}

}  // namespace svt
