// Native dataset decode path: minimal PNG reader (zlib inflate + unfilter).
//
// Replaces the reference's cv::imread in the frame loop (main.cpp:94-95).
// TUM RGB-D sequences ship 8-bit RGB color images and 16-bit grayscale
// depth images; both are supported, plus 8-bit gray/RGBA.  Exposed to
// Python via a C ABI (ctypes binding in aslam_tpu_torch/native/loader.py).
//
// Build: python -m aslam_tpu_torch.native.build

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint32_t u32() {
    if (off + 4 > n) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                 (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]);
    off += 4;
    return v;
  }
};

int paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// Decode a PNG file.  On success returns 0 and fills width/height/channels/
// bit_depth and a malloc'd buffer (row-major, channels interleaved;
// 16-bit data as native-endian uint16).  Caller frees with aslam_free.
int aslam_decode_png(const char* path, int* out_w, int* out_h, int* out_c,
                     int* out_bits, void** out_buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 8) { std::fclose(f); return -2; }
  std::vector<uint8_t> data{};
  data.resize(size_t(fsize));
  if (std::fread(data.data(), 1, size_t(fsize), f) != size_t(fsize)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (std::memcmp(data.data(), magic, 8) != 0) return -3;

  Reader r{data.data(), data.size(), 8};
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = -1;
  std::vector<uint8_t> idat;

  while (r.ok && r.off + 8 <= r.n) {
    uint32_t len = r.u32();
    if (r.off + 4 > r.n) break;
    char type[5] = {0};
    std::memcpy(type, r.p + r.off, 4);
    r.off += 4;
    if (r.off + len + 4 > r.n) break;
    const uint8_t* chunk = r.p + r.off;

    if (std::strcmp(type, "IHDR") == 0 && len >= 13) {
      width = (uint32_t(chunk[0]) << 24) | (uint32_t(chunk[1]) << 16) |
              (uint32_t(chunk[2]) << 8) | chunk[3];
      height = (uint32_t(chunk[4]) << 24) | (uint32_t(chunk[5]) << 16) |
               (uint32_t(chunk[6]) << 8) | chunk[7];
      bit_depth = chunk[8];
      color_type = chunk[9];
      int interlace = chunk[12];
      if (interlace != 0) return -4;  // Adam7 unsupported
    } else if (std::strcmp(type, "IDAT") == 0) {
      idat.insert(idat.end(), chunk, chunk + len);
    } else if (std::strcmp(type, "IEND") == 0) {
      r.off += len + 4;
      break;
    }
    r.off += len + 4;  // skip data + CRC
  }

  if (width == 0 || height == 0 || idat.empty()) return -5;
  if (bit_depth != 8 && bit_depth != 16) return -6;

  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // RGB
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // RGBA
    default: return -6;           // palette unsupported
  }

  const size_t bpp = size_t(channels) * (bit_depth / 8);   // bytes per pixel
  const size_t stride = bpp * width;
  std::vector<uint8_t> raw(height * (stride + 1));
  uLongf raw_len = uLongf(raw.size());
  if (uncompress(raw.data(), &raw_len, idat.data(), uLong(idat.size())) != Z_OK ||
      raw_len != raw.size()) {
    return -7;
  }

  uint8_t* out = static_cast<uint8_t*>(std::malloc(height * stride));
  if (!out) return -8;

  // per-scanline unfilter
  std::vector<uint8_t> prev(stride, 0);
  for (uint32_t y = 0; y < height; y++) {
    const uint8_t* src = raw.data() + y * (stride + 1);
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    uint8_t* dst = out + y * stride;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= bpp ? dst[x - bpp] : 0;
      int b = prev[x];
      int c = x >= bpp ? prev[x - bpp] : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: std::free(out); return -9;
      }
      dst[x] = uint8_t(v);
    }
    std::memcpy(prev.data(), dst, stride);
  }

  // 16-bit PNG is big-endian; convert to native-endian uint16
  if (bit_depth == 16) {
    size_t n16 = height * stride / 2;
    uint16_t* p16 = reinterpret_cast<uint16_t*>(out);
    for (size_t i = 0; i < n16; i++) {
      uint8_t hi = out[2 * i], lo = out[2 * i + 1];
      p16[i] = uint16_t((hi << 8) | lo);
    }
  }

  *out_w = int(width);
  *out_h = int(height);
  *out_c = channels;
  *out_bits = bit_depth;
  *out_buf = out;
  return 0;
}

void aslam_free(void* p) { std::free(p); }

}  // extern "C"
