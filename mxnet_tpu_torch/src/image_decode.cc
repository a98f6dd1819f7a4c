// Native image decode for the port's input path (the host side of
// ImageRecordIter: the reference decodes with an OpenCV/libjpeg OpenMP
// team, iter_image_recordio_2.cc). The Python decode pool calls these
// entry points through ctypes, which releases the GIL, so worker threads
// decode in parallel where PIL would serialize.
//
// JPEG: libjpeg is resolved at RUN TIME via dlopen, so the library builds
// and loads everywhere; hosts without libjpeg fall back to PIL/cv2
// (imdecode_jpeg returns -1).
//
// PNG: 8-bit gray, RGB and RGBA, not interlaced, all five row filters,
// inflated by zlib's uncompress() from a dlopen of libz.so.1. PNG is
// lossless, so the pixels equal PIL's bit for bit, the gray conversion
// included (PIL's L = (19595 R + 38470 G + 7471 B + 0x8000) >> 16). Any
// other PNG (16-bit, palette, gray+alpha, interlaced) returns -1 and falls
// back to PIL, then cv2.
#include <csetjmp>
#include <cstdint>
#include <cstring>

#if defined(__has_include)
#if __has_include(<jpeglib.h>) && __has_include(<dlfcn.h>)
#define MXTPU_HAVE_JPEG 1
#endif
#endif

#ifdef MXTPU_HAVE_JPEG
#include <dlfcn.h>
#include <cstdio>  // jpeglib.h needs FILE
#include <jpeglib.h>

namespace {

struct JpegApi {
  struct jpeg_error_mgr* (*std_error)(struct jpeg_error_mgr*);
  void (*create_decompress)(j_decompress_ptr, int, size_t);
  void (*mem_src)(j_decompress_ptr, const unsigned char*, unsigned long);
  int (*read_header)(j_decompress_ptr, boolean);
  boolean (*start_decompress)(j_decompress_ptr);
  JDIMENSION (*read_scanlines)(j_decompress_ptr, JSAMPARRAY, JDIMENSION);
  boolean (*finish_decompress)(j_decompress_ptr);
  void (*destroy_decompress)(j_decompress_ptr);
  bool ok = false;
};

bool bind_api(void* h, JpegApi* api) {
  auto sym = [h](const char* n) { return dlsym(h, n); };
  api->std_error = reinterpret_cast<decltype(api->std_error)>(
      sym("jpeg_std_error"));
  api->create_decompress = reinterpret_cast<decltype(api->create_decompress)>(
      sym("jpeg_CreateDecompress"));
  api->mem_src = reinterpret_cast<decltype(api->mem_src)>(
      sym("jpeg_mem_src"));
  api->read_header = reinterpret_cast<decltype(api->read_header)>(
      sym("jpeg_read_header"));
  api->start_decompress = reinterpret_cast<decltype(api->start_decompress)>(
      sym("jpeg_start_decompress"));
  api->read_scanlines = reinterpret_cast<decltype(api->read_scanlines)>(
      sym("jpeg_read_scanlines"));
  api->finish_decompress = reinterpret_cast<decltype(api->finish_decompress)>(
      sym("jpeg_finish_decompress"));
  api->destroy_decompress =
      reinterpret_cast<decltype(api->destroy_decompress)>(
          sym("jpeg_destroy_decompress"));
  return api->std_error && api->create_decompress && api->mem_src &&
         api->read_header && api->start_decompress && api->read_scanlines &&
         api->finish_decompress && api->destroy_decompress;
}

JpegApi load_api() {
  JpegApi api;
  // Prefer the soname matching the COMPILED JPEG_LIB_VERSION: the
  // runtime version/structsize check in jpeg_CreateDecompress rejects
  // mismatched ABIs, so starting with the matching one avoids pinning a
  // library we can't actually use.
#if JPEG_LIB_VERSION >= 90
  const char* candidates[] = {"libjpeg.so.9", "libjpeg.so",
                              "libjpeg.so.8", "libjpeg.so.62"};
#elif JPEG_LIB_VERSION >= 80
  const char* candidates[] = {"libjpeg.so.8", "libjpeg.so",
                              "libjpeg.so.9", "libjpeg.so.62"};
#else
  const char* candidates[] = {"libjpeg.so.62", "libjpeg.so",
                              "libjpeg.so.8", "libjpeg.so.9"};
#endif
  for (const char* name : candidates) {
    // RTLD_LOCAL: all symbols are fetched via dlsym, and exporting the
    // system libjpeg globally could interpose onto the DIFFERENT libjpeg
    // build PIL/cv2 bundle for the fallback path (ABI mismatch crash)
    void* h = dlopen(name, RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) continue;
    if (bind_api(h, &api)) {
      api.ok = true;
      return api;
    }
    dlclose(h);  // unusable build (e.g. no jpeg_mem_src): try the next
  }
  api.ok = false;
  return api;
}

void on_emit_message(j_common_ptr, int) {
  // corrupt-but-decodable inputs would otherwise spam stderr from every
  // decode-pool worker thread (the PIL path this replaces is silent)
}
void on_output_message(j_common_ptr) {}

const JpegApi& api() {
  static JpegApi a = load_api();
  return a;
}

struct ErrorTrap {
  struct jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorTrap* trap = reinterpret_cast<ErrorTrap*>(cinfo->err);
  longjmp(trap->jump, 1);
}

}  // namespace

extern "C" {

// Decode a JPEG buffer to tightly-packed RGB8 (gray=1 -> single
// channel). Returns the byte size written (or required, when out is
// null/too small) or -1 when the buffer is not decodable / libjpeg is
// unavailable. w/h/c receive the image dims.
long long imdecode_jpeg(const unsigned char* buf, long long len,
                        unsigned char* out, long long cap, int gray,
                        int* w, int* h, int* c) {
  const JpegApi& J = api();
  if (!J.ok || buf == nullptr || len < 4) return -1;
  struct jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = J.std_error(&trap.mgr);
  trap.mgr.error_exit = on_error;
  trap.mgr.emit_message = on_emit_message;
  trap.mgr.output_message = on_output_message;
  if (setjmp(trap.jump)) {
    J.destroy_decompress(&cinfo);
    return -1;
  }
  J.create_decompress(&cinfo, JPEG_LIB_VERSION,
                      sizeof(struct jpeg_decompress_struct));
  J.mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (J.read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    J.destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  J.start_decompress(&cinfo);
  const int width = static_cast<int>(cinfo.output_width);
  const int height = static_cast<int>(cinfo.output_height);
  const int channels = cinfo.output_components;
  const long long need =
      static_cast<long long>(width) * height * channels;
  if (w != nullptr) *w = width;
  if (h != nullptr) *h = height;
  if (c != nullptr) *c = channels;
  if (out == nullptr || cap < need) {
    J.destroy_decompress(&cinfo);
    return need;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long long>(cinfo.output_scanline) *
                             width * channels;
    J.read_scanlines(&cinfo, &row, 1);
  }
  J.finish_decompress(&cinfo);
  J.destroy_decompress(&cinfo);
  return need;
}

}  // extern "C"

#else  // !MXTPU_HAVE_JPEG

extern "C" long long imdecode_jpeg(const unsigned char*, long long,
                                   unsigned char*, long long, int, int*,
                                   int*, int*) {
  return -1;
}

#endif


// ---------------------------------------------------------------------
// PNG (no libpng needed: the format's filters are a few lines; inflate is
// zlib's one-shot uncompress()).
// ---------------------------------------------------------------------
#include <dlfcn.h>

#include <cstdlib>
#include <vector>

namespace {

typedef int (*uncompress_fn)(unsigned char*, unsigned long*,
                             const unsigned char*, unsigned long);

uncompress_fn load_uncompress() {
  const char* names[] = {"libz.so.1", "libz.so"};
  for (const char* name : names) {
    void* h = dlopen(name, RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) continue;
    void* f = dlsym(h, "uncompress");
    if (f != nullptr) return reinterpret_cast<uncompress_fn>(f);
    dlclose(h);
  }
  return nullptr;
}

uncompress_fn zlib_uncompress() {
  static uncompress_fn f = load_uncompress();
  return f;
}

inline uint32_t png_be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Reverse the row filters in place over `raw` (height rows of 1 filter
// byte + stride bytes); false on an unknown filter type.
bool unfilter(unsigned char* raw, int height, long long stride, int bpp) {
  const unsigned char* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    unsigned char* row = raw + static_cast<long long>(y) * (stride + 1);
    const int filter = row[0];
    unsigned char* x = row + 1;
    switch (filter) {
      case 0:
        break;
      case 1:
        for (long long i = bpp; i < stride; ++i) x[i] += x[i - bpp];
        break;
      case 2:
        if (prev != nullptr)
          for (long long i = 0; i < stride; ++i) x[i] += prev[i];
        break;
      case 3:
        for (long long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int b = prev != nullptr ? prev[i] : 0;
          x[i] += static_cast<unsigned char>((a + b) >> 1);
        }
        break;
      case 4:
        for (long long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int b = prev != nullptr ? prev[i] : 0;
          const int c = (prev != nullptr && i >= bpp) ? prev[i - bpp] : 0;
          x[i] += static_cast<unsigned char>(paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
    prev = x;
  }
  return true;
}

}  // namespace

extern "C" {

// Decode a PNG buffer to tightly packed RGB8 (gray=1: one L channel).
// Returns the byte size written (or required, when out is null or too
// small) or -1 when the buffer is not a PNG this path decodes or zlib is
// not on this host. w/h/c receive the output dims.
long long imdecode_png(const unsigned char* buf, long long len,
                       unsigned char* out, long long cap, int gray, int* w,
                       int* h, int* c) {
  static const unsigned char kSig[8] = {0x89, 'P', 'N', 'G',
                                        '\r', '\n', 0x1a, '\n'};
  if (buf == nullptr || len < 8 + 25 || std::memcmp(buf, kSig, 8) != 0)
    return -1;
  long long pos = 8;
  int width = 0, height = 0, ctype = -1;
  bool have_ihdr = false;
  std::vector<unsigned char> idat;
  while (pos + 12 <= len) {
    const uint32_t n = png_be32(buf + pos);
    const unsigned char* type = buf + pos + 4;
    const unsigned char* data = buf + pos + 8;
    if (pos + 12 + static_cast<long long>(n) > len) return -1;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (n != 13) return -1;
      width = static_cast<int>(png_be32(data));
      height = static_cast<int>(png_be32(data + 4));
      const int depth = data[8];
      ctype = data[9];
      // compression 0, filter method 0, no interlace
      if (depth != 8 || data[10] != 0 || data[11] != 0 || data[12] != 0)
        return -1;
      if (ctype != 0 && ctype != 2 && ctype != 6) return -1;
      if (width <= 0 || height <= 0) return -1;
      have_ihdr = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + n);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + static_cast<long long>(n);
  }
  if (!have_ihdr || idat.empty()) return -1;
  const int cin = ctype == 0 ? 1 : (ctype == 2 ? 3 : 4);
  const int cout = gray ? 1 : 3;
  const long long need = static_cast<long long>(width) * height * cout;
  if (w != nullptr) *w = width;
  if (h != nullptr) *h = height;
  if (c != nullptr) *c = cout;
  if (out == nullptr || cap < need) return need;
  uncompress_fn inflate_all = zlib_uncompress();
  if (inflate_all == nullptr) return -1;
  const long long stride = static_cast<long long>(width) * cin;
  const long long raw_len = (stride + 1) * height;
  std::vector<unsigned char> raw(static_cast<size_t>(raw_len));
  unsigned long got = static_cast<unsigned long>(raw_len);
  if (inflate_all(raw.data(), &got, idat.data(),
                  static_cast<unsigned long>(idat.size())) != 0 ||
      static_cast<long long>(got) != raw_len)
    return -1;
  if (!unfilter(raw.data(), height, stride, cin)) return -1;
  for (int y = 0; y < height; ++y) {
    const unsigned char* src = raw.data() + y * (stride + 1) + 1;
    unsigned char* dst = out + static_cast<long long>(y) * width * cout;
    for (int x = 0; x < width; ++x, src += cin) {
      if (cout == 1) {
        dst[x] = cin == 1 ? src[0]
                          : static_cast<unsigned char>(
                                (src[0] * 19595u + src[1] * 38470u +
                                 src[2] * 7471u + 0x8000u) >> 16);
      } else if (cin == 1) {
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = src[0];
      } else {
        dst[3 * x] = src[0];
        dst[3 * x + 1] = src[1];
        dst[3 * x + 2] = src[2];
      }
    }
  }
  return need;
}

}  // extern "C"
