// rayeater_native — host-side native tier (C++17, ctypes ABI).
//
// The reference links native components for windowing and asset IO (GLFW
// static lib, the rshc image loader; build.zig:36-49, image.zig:437). This
// library is their TPU-framework counterpart: the host-side hot paths that
// sit outside XLA — binary PLY splat-scene parsing and PNG encode/decode
// for the present stream — implemented natively so a 60 FPS readback loop
// is not bottlenecked on Python codecs.
//
// ABI: plain C functions (ctypes); all buffers caller-allocated after a
// probe call. Thread-safe: no globals besides errno-style messages per
// call returned as negative codes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PLY (3DGS vertex layout: float32 properties, binary_little_endian/ascii)
// ---------------------------------------------------------------------------

// Probe: returns 0 on success; fills *n_verts, *n_props, and writes the
// property names joined by '\n' into names_buf (cap bytes).
// Errors: -1 open, -2 header, -3 non-float property, -4 names_buf small.
int re_ply_probe(const char* path, int64_t* n_verts, int32_t* n_props,
                 char* names_buf, int32_t names_cap, int64_t* data_offset,
                 int32_t* is_ascii) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  std::string names;
  int64_t n = 0;
  int props = 0;
  int ascii = -1;
  bool in_vertex = false;
  while (fgets(line, sizeof line, f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.rfind("format ", 0) == 0) {
      if (s.find("binary_little_endian") != std::string::npos) ascii = 0;
      else if (s.find("ascii") != std::string::npos) ascii = 1;
      else { fclose(f); return -2; }
    } else if (s.rfind("element vertex ", 0) == 0) {
      n = atoll(s.c_str() + 15);
      in_vertex = true;
    } else if (s.rfind("element ", 0) == 0) {
      in_vertex = false;
    } else if (in_vertex && s.rfind("property ", 0) == 0) {
      if (s.rfind("property float ", 0) != 0) { fclose(f); return -3; }
      if (!names.empty()) names += '\n';
      names += s.substr(15);
      props++;
    } else if (s == "end_header") {
      *n_verts = n;
      *n_props = props;
      *data_offset = ftell(f);
      *is_ascii = ascii;
      if ((int32_t)names.size() + 1 > names_cap) { fclose(f); return -4; }
      memcpy(names_buf, names.c_str(), names.size() + 1);
      fclose(f);
      return (n > 0 && props > 0 && ascii >= 0) ? 0 : -2;
    }
  }
  fclose(f);
  return -2;
}

// Read vertex data into out (n_verts*n_props float32, row-major).
// Returns 0 ok, -1 open, -5 short read / parse error.
int re_ply_read(const char* path, int64_t data_offset, int32_t is_ascii,
                int64_t n_verts, int32_t n_props, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, (long)data_offset, SEEK_SET) != 0) { fclose(f); return -5; }
  int64_t total = n_verts * (int64_t)n_props;
  if (!is_ascii) {
    int64_t got = (int64_t)fread(out, sizeof(float), (size_t)total, f);
    fclose(f);
    return got == total ? 0 : -5;
  }
  for (int64_t i = 0; i < total; i++) {
    if (fscanf(f, "%f", &out[i]) != 1) { fclose(f); return -5; }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG encode (8-bit RGB/RGBA, zlib deflate, per-row filter 0)
// ---------------------------------------------------------------------------

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24); v.push_back(x >> 16); v.push_back(x >> 8);
  v.push_back(x);
}

static void put_chunk(std::vector<uint8_t>& out, const char type[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, (uInt)(len + 4));
  put_be32(out, crc);
}

// Encode rgba (h*w*channels u8, channels 3 or 4). Probe with out=nullptr:
// returns required byte count (upper bound). Second call writes and
// returns actual size; negative on error.
int64_t re_png_encode(const uint8_t* pixels, int32_t h, int32_t w,
                      int32_t channels, uint8_t* out, int64_t out_cap) {
  if (channels != 3 && channels != 4) return -1;
  size_t row = (size_t)w * channels;
  std::vector<uint8_t> raw((row + 1) * h);
  for (int y = 0; y < h; y++) {
    raw[y * (row + 1)] = 0;  // filter type 0
    memcpy(&raw[y * (row + 1) + 1], pixels + y * row, row);
  }
  uLongf comp_cap = compressBound((uLong)raw.size());
  if (!out) return (int64_t)(comp_cap + 1024);
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 6)
      != Z_OK)
    return -2;

  std::vector<uint8_t> png;
  png.reserve(comp_cap + 256);
  const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  png.insert(png.end(), sig, sig + 8);
  uint8_t ihdr[13];
  // width, height big-endian
  ihdr[0] = w >> 24; ihdr[1] = w >> 16; ihdr[2] = w >> 8; ihdr[3] = w;
  ihdr[4] = h >> 24; ihdr[5] = h >> 16; ihdr[6] = h >> 8; ihdr[7] = h;
  ihdr[8] = 8;                          // bit depth
  ihdr[9] = channels == 4 ? 6 : 2;      // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;   // compression/filter/interlace
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", comp.data(), comp_cap);
  put_chunk(png, "IEND", nullptr, 0);
  if ((int64_t)png.size() > out_cap) return -3;
  memcpy(out, png.data(), png.size());
  return (int64_t)png.size();
}

// ---------------------------------------------------------------------------
// PNG decode (8-bit RGB/RGBA/gray[+alpha], non-interlaced)
// ---------------------------------------------------------------------------

static uint8_t paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// Probe: fills h/w/channels from IHDR; returns 0 ok.
int re_png_probe(const uint8_t* buf, int64_t len, int32_t* h, int32_t* w,
                 int32_t* channels) {
  if (len < 33 || memcmp(buf, "\x89PNG\r\n\x1a\n", 8) != 0) return -1;
  if (memcmp(buf + 12, "IHDR", 4) != 0) return -1;
  *w = (buf[16] << 24) | (buf[17] << 16) | (buf[18] << 8) | buf[19];
  *h = (buf[20] << 24) | (buf[21] << 16) | (buf[22] << 8) | buf[23];
  int depth = buf[24], color = buf[25], interlace = buf[28];
  if (depth != 8 || interlace != 0) return -2;
  switch (color) {
    case 0: *channels = 1; break;
    case 2: *channels = 3; break;
    case 4: *channels = 2; break;
    case 6: *channels = 4; break;
    default: return -2;    // palette unsupported
  }
  return 0;
}

// Decode into out (h*w*channels). Returns 0 ok.
int re_png_decode(const uint8_t* buf, int64_t len, int32_t h, int32_t w,
                  int32_t channels, uint8_t* out) {
  // concatenate IDAT chunks
  std::vector<uint8_t> idat;
  int64_t pos = 8;
  while (pos + 12 <= len) {
    uint32_t clen = (buf[pos] << 24) | (buf[pos + 1] << 16)
                    | (buf[pos + 2] << 8) | buf[pos + 3];
    // bounds: a corrupt length field must not read past the buffer
    if ((int64_t)clen > len - pos - 12) return -4;
    const uint8_t* type = buf + pos + 4;
    if (memcmp(type, "IDAT", 4) == 0)
      idat.insert(idat.end(), buf + pos + 8, buf + pos + 8 + clen);
    if (memcmp(type, "IEND", 4) == 0) break;
    pos += 12 + clen;
  }
  if (idat.empty()) return -1;
  size_t row = (size_t)w * channels;
  std::vector<uint8_t> raw((row + 1) * h);
  uLongf raw_len = (uLongf)raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), (uLong)idat.size())
      != Z_OK || raw_len != raw.size())
    return -2;
  // unfilter
  std::vector<uint8_t> prev(row, 0);
  for (int y = 0; y < h; y++) {
    uint8_t ft = raw[y * (row + 1)];
    uint8_t* cur = &raw[y * (row + 1) + 1];
    for (size_t x = 0; x < row; x++) {
      int a = x >= (size_t)channels ? cur[x - channels] : 0;
      int b = prev[x];
      int c = x >= (size_t)channels ? prev[x - channels] : 0;
      switch (ft) {
        case 0: break;
        case 1: cur[x] = (uint8_t)(cur[x] + a); break;
        case 2: cur[x] = (uint8_t)(cur[x] + b); break;
        case 3: cur[x] = (uint8_t)(cur[x] + ((a + b) >> 1)); break;
        case 4: cur[x] = (uint8_t)(cur[x] + paeth(a, b, c)); break;
        default: return -3;
      }
    }
    memcpy(out + y * row, cur, row);
    memcpy(prev.data(), cur, row);
  }
  return 0;
}

int re_version() { return 1; }

}  // extern "C"
