// Native record-IO core: TFRecord-framed sequential files with crc32c
// (Castagnoli) integrity, exposed over a plain C ABI for ctypes.
//
// Framing (TFRecord wire format — the reference ecosystem's on-disk
// training-data container, k8s-operator.md:6's per-task input files):
//
//   uint64le  data_length
//   uint32le  masked_crc32c(data_length bytes)
//   bytes     data[data_length]
//   uint32le  masked_crc32c(data)
//
// masked_crc(c) = ((c >> 15) | (c << 17)) + 0xa282ead8  (mod 2^32)
//
// The hot path a Python loop can't serve: indexing a multi-GB shard
// (sequential scan, header-CRC verified) and bulk record reads with
// data-CRC verification — both single-pass, zero Python per record.
// The Python side (../recordio.py) carries a pure-Python
// fallback with identical semantics for rigs without a toolchain.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// crc32c, reflected polynomial 0x82F63B78, byte-at-a-time table.
uint32_t kTable[256];
bool table_init = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    kTable[i] = c;
  }
  return true;
}();

uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
  for (size_t i = 0; i < n; ++i)
    crc = kTable[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__x86_64__)
// The SSE4.2 crc32 instruction computes exactly CRC-32C (Castagnoli) —
// 8 bytes per instruction vs 1 byte per table lookup (~10x). Compiled
// with a per-function target attribute and dispatched at runtime so the
// shared object still loads on pre-SSE4.2 CPUs.
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t crc) {
  uint64_t c = ~crc;
  while (n >= 8) {
    uint64_t v;
    __builtin_memcpy(&v, p, 8);  // unaligned-safe
    c = __builtin_ia32_crc32di(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = (uint32_t)c;
  while (n--) c32 = __builtin_ia32_crc32qi(c32, *p++);
  return ~c32;
}

const bool kHaveHwCrc = [] {
  __builtin_cpu_init();
  return (bool)__builtin_cpu_supports("sse4.2");
}();
#else
const bool kHaveHwCrc = false;
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t crc) {
  return crc32c_sw(p, n, crc);
}
#endif

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc = 0) {
  return kHaveHwCrc ? crc32c_hw(p, n, crc) : crc32c_sw(p, n, crc);
}

uint32_t masked(uint32_t c) {
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

uint64_t le64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

void put_le(uint8_t* p, uint64_t v, int n) {
  for (int i = 0; i < n; ++i) p[i] = (uint8_t)(v >> (8 * i));
}

}  // namespace

extern "C" {

// Exposed so the Python writer can use the fast CRC when native is up.
uint32_t rio_crc32c(const uint8_t* data, int64_t n) {
  return crc32c(data, (size_t)n);
}

uint32_t rio_masked_crc32c(const uint8_t* data, int64_t n) {
  return masked(crc32c(data, (size_t)n));
}

// Scan a record file, verifying every header CRC. On success returns the
// record count and malloc'd arrays (caller frees via rio_free) of each
// record's DATA offset and length. Negative return = error:
//   -1 open failed, -2 truncated frame, -3 header CRC mismatch,
//   -5 out of memory growing the index.
int64_t rio_index(const char* path, int64_t** offsets, int64_t** lengths) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // file size up front: fseek past EOF SUCCEEDS (and ftell then reports
  // the past-EOF position), so truncation must be checked against the
  // real size, not the stream position
#if defined(_WIN32)
  _fseeki64(f, 0, SEEK_END);
  const int64_t fsize = _ftelli64(f);
  _fseeki64(f, 0, SEEK_SET);
#else
  fseeko(f, 0, SEEK_END);
  const int64_t fsize = (int64_t)ftello(f);
  fseeko(f, 0, SEEK_SET);
#endif
  int64_t cap = 1024, n = 0;
  int64_t* offs = (int64_t*)malloc(cap * sizeof(int64_t));
  int64_t* lens = (int64_t*)malloc(cap * sizeof(int64_t));
  if (!offs || !lens) {
    free(offs);
    free(lens);
    fclose(f);
    return -5;
  }
  uint8_t hdr[12];
  int64_t rc = 0;
  for (;;) {
    size_t got = fread(hdr, 1, 12, f);
    if (got == 0) break;  // clean EOF
    if (got != 12) { rc = -2; break; }
    uint64_t len = le64(hdr);
    if (masked(crc32c(hdr, 8)) != le32(hdr + 8)) { rc = -3; break; }
    int64_t off;
#if defined(_WIN32)
    off = _ftelli64(f);
#else
    off = ftello(f);
#endif
    if (off + (int64_t)len + 4 > fsize) { rc = -2; break; }  // truncated body
    if (n == cap) {
      cap *= 2;
      // checked growth: a failed realloc returns NULL and LEAVES the old
      // block valid — assigning unchecked would both leak it and crash on
      // the next store
      int64_t* no = (int64_t*)realloc(offs, cap * sizeof(int64_t));
      if (!no) { rc = -5; break; }
      offs = no;
      int64_t* nl = (int64_t*)realloc(lens, cap * sizeof(int64_t));
      if (!nl) { rc = -5; break; }
      lens = nl;
    }
    offs[n] = off;
    lens[n] = (int64_t)len;
    ++n;
    // skip data + its 4-byte CRC without reading it (index is O(records))
#if defined(_WIN32)
    if (_fseeki64(f, (int64_t)len + 4, SEEK_CUR) != 0) { rc = -2; break; }
#else
    if (fseeko(f, (off_t)len + 4, SEEK_CUR) != 0) { rc = -2; break; }
#endif
  }
  fclose(f);
  if (rc < 0) {
    free(offs);
    free(lens);
    return rc;
  }
  *offsets = offs;
  *lengths = lens;
  return n;
}

void rio_free(void* p) { free(p); }

// Read `count` records (data offsets/lengths from rio_index) into `out`,
// packed back to back; the caller sizes `out` as sum(lengths). Each
// record's trailing data CRC is verified when verify != 0. Returns 0 on
// success; -1 open, -2 short read, -4 data CRC mismatch at record i
// (encoded as -(4 + i*10)... keep simple: returns -4 and writes the
// failing record index into *bad_index when non-null).
int64_t rio_read(const char* path, int64_t count, const int64_t* offsets,
                 const int64_t* lengths, uint8_t* out, int verify,
                 int64_t* bad_index) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t tail[4];
  uint8_t* dst = out;
  for (int64_t i = 0; i < count; ++i) {
#if defined(_WIN32)
    if (_fseeki64(f, offsets[i], SEEK_SET) != 0) { fclose(f); return -2; }
#else
    if (fseeko(f, (off_t)offsets[i], SEEK_SET) != 0) { fclose(f); return -2; }
#endif
    if (fread(dst, 1, (size_t)lengths[i], f) != (size_t)lengths[i]) {
      fclose(f);
      return -2;
    }
    if (verify) {
      if (fread(tail, 1, 4, f) != 4) { fclose(f); return -2; }
      if (masked(crc32c(dst, (size_t)lengths[i])) != le32(tail)) {
        if (bad_index) *bad_index = i;
        fclose(f);
        return -4;
      }
    }
    dst += lengths[i];
  }
  fclose(f);
  return 0;
}

// Append `count` records to `path` (created if absent) in TFRecord
// framing. Data is packed back to back in `data` with per-record
// `lengths`. Returns 0 or -1 (open) / -2 (short write).
int64_t rio_write(const char* path, int64_t count, const uint8_t* data,
                  const int64_t* lengths) {
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  uint8_t hdr[12], tail[4];
  const uint8_t* src = data;
  for (int64_t i = 0; i < count; ++i) {
    put_le(hdr, (uint64_t)lengths[i], 8);
    put_le(hdr + 8, masked(crc32c(hdr, 8)), 4);
    put_le(tail, masked(crc32c(src, (size_t)lengths[i])), 4);
    if (fwrite(hdr, 1, 12, f) != 12 ||
        fwrite(src, 1, (size_t)lengths[i], f) != (size_t)lengths[i] ||
        fwrite(tail, 1, 4, f) != 4) {
      fclose(f);
      return -2;
    }
    src += lengths[i];
  }
  if (fclose(f) != 0) return -2;
  return 0;
}

}  // extern "C"
