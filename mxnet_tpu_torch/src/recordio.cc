// Native RecordIO reader/writer + MNIST/CSV parsers.
//
// Capability parity: reference src/io/ + dmlc-core RecordIO. The dmlc wire
// format is kept (magic 0xced7230a, lrecord header, 4-byte alignment) so
// .rec files interoperate with files written by the python layer, by the
// JAX package and by the reference's im2rec.
//
// The reader mmaps the file and indexes record offsets in one pass, then
// serves random/sequential reads with zero copies until the python
// boundary — the native fast path under io.py/image.py, replacing the
// reference's dmlc::RecordIOSplitter + OpenMP parse workers.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {
constexpr uint32_t kMagic = 0xced7230a;

inline uint32_t DecodeLength(uint32_t lrec) { return lrec & ((1u << 29) - 1); }
}  // namespace

extern "C" {

struct RecReader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<size_t> offsets;  // payload offsets
  std::vector<uint32_t> lengths;
};

// Open + index a RecordIO file. Returns nullptr on failure.
RecReader* recio_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* r = new RecReader();
  r->fd = fd;
  r->base = static_cast<const uint8_t*>(mem);
  r->size = static_cast<size_t>(st.st_size);
  size_t pos = 0;
  while (pos + 8 <= r->size) {
    uint32_t magic, lrec;
    std::memcpy(&magic, r->base + pos, 4);
    std::memcpy(&lrec, r->base + pos + 4, 4);
    if (magic != kMagic) break;
    uint32_t len = DecodeLength(lrec);
    if (pos + 8 + len > r->size) break;
    r->offsets.push_back(pos + 8);
    r->lengths.push_back(len);
    size_t advance = 8 + len;
    advance += (4 - len % 4) % 4;  // alignment padding
    pos += advance;
  }
  return r;
}

int64_t recio_num_records(RecReader* r) {
  return static_cast<int64_t>(r->offsets.size());
}

// Pointer+length of record i (zero-copy view into the mmap).
const uint8_t* recio_record(RecReader* r, int64_t i, int64_t* out_len) {
  if (i < 0 || static_cast<size_t>(i) >= r->offsets.size()) {
    *out_len = 0;
    return nullptr;
  }
  *out_len = r->lengths[i];
  return r->base + r->offsets[i];
}

// Payload byte offset of record i (record start + 8-byte header), so
// callers can reconcile external .idx files against physical layout.
int64_t recio_payload_offset(RecReader* r, int64_t i) {
  if (i < 0 || static_cast<size_t>(i) >= r->offsets.size()) return -1;
  return static_cast<int64_t>(r->offsets[i]);
}

void recio_close(RecReader* r) {
  if (!r) return;
  if (r->base) munmap(const_cast<uint8_t*>(r->base), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

// ---------------------------------------------------------------------
// MNIST idx format parse (parity iter_mnist.cc): big-endian header, raw
// uint8 payload. Returns 0 on success; fills caller-allocated buffer.
// ---------------------------------------------------------------------
static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int mnist_read_header(const char* path, int64_t* dims, int* ndim) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[4];
  if (fread(hdr, 1, 4, f) != 4) {
    fclose(f);
    return -1;
  }
  int nd = hdr[3];
  *ndim = nd;
  for (int i = 0; i < nd; ++i) {
    uint8_t b[4];
    if (fread(b, 1, 4, f) != 4) {
      fclose(f);
      return -1;
    }
    dims[i] = be32(b);
  }
  fclose(f);
  return 0;
}

int mnist_read_data(const char* path, uint8_t* out, int64_t count) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[4];
  if (fread(hdr, 1, 4, f) != 4) {
    fclose(f);
    return -1;
  }
  int nd = hdr[3];
  fseek(f, 4 + 4 * nd, SEEK_SET);
  size_t got = fread(out, 1, count, f);
  fclose(f);
  return got == static_cast<size_t>(count) ? 0 : -1;
}

// ---------------------------------------------------------------------
// CSV float parser (parity iter_csv.cc): parse a whole file of
// comma-separated floats into a caller buffer. Returns #values parsed.
// Much faster than numpy.loadtxt for large files.
// ---------------------------------------------------------------------
int64_t csv_parse_floats(const char* path, float* out, int64_t capacity) {
  // Read into a NUL-terminated heap buffer: strtof scans to a terminator,
  // so parsing straight off an mmap whose size is an exact page multiple
  // would run past the mapping on a file ending mid-number.
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return -1;
  }
  char* buf = static_cast<char*>(malloc(st.st_size + 1));
  if (!buf) {
    ::close(fd);
    return -1;
  }
  size_t got = 0;
  while (got < static_cast<size_t>(st.st_size)) {
    ssize_t k = ::read(fd, buf + got, st.st_size - got);
    if (k < 0) {  // I/O error: fail loudly, never return a truncated parse
      free(buf);
      ::close(fd);
      return -1;
    }
    if (k == 0) break;  // EOF (file shrank since fstat)
    got += static_cast<size_t>(k);
  }
  ::close(fd);
  buf[got] = '\0';
  const char* p = buf;
  const char* end = buf + got;
  int64_t n = 0;
  while (p < end && n < capacity) {
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) {
      ++p;  // skip separators / newlines
      continue;
    }
    out[n++] = v;
    p = next;
  }
  free(buf);
  return n;
}

}  // extern "C"
