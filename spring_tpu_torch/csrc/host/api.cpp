// extern "C" API of the native host library — loaded from Python via ctypes
// (codecs/native.py). Multi-block framing + OpenMP block
// parallelism live here; one-block logic is in xbc.cpp / idcodec.cpp.
//
// Reference analog: the file/string-array wrappers around libbsc
// (src/libbsc/bsc.cpp, bsc_str_array.cpp) and Spring's per-thread
// block loops.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace stpu {
int64_t xbc_compress_block(const uint8_t* src, int64_t n, std::vector<uint8_t>& out);
int64_t xbc_decompress_block(const uint8_t* src, int64_t in_len, uint8_t* dst,
                             int64_t dst_cap);
int64_t id_compress_block(const uint8_t* ids, const uint32_t* lens, uint32_t count,
                          std::vector<uint8_t>& out);
int64_t id_decompress_block(const uint8_t* src, int64_t src_len,
                            std::vector<uint8_t>& out, std::vector<uint32_t>& lens);
}  // namespace stpu

namespace {

inline void put_u64(uint8_t* p, uint64_t x) {
  for (int i = 0; i < 8; ++i) p[i] = (uint8_t)(x >> (8 * i));
}
inline uint64_t get_u64(const uint8_t* p) {
  uint64_t x = 0;
  for (int i = 0; i < 8; ++i) x |= (uint64_t)p[i] << (8 * i);
  return x;
}

}  // namespace

extern "C" {

// upper bound on compressed size for n raw bytes
int64_t stpu_xbc_bound(int64_t n, int64_t block_size) {
  if (block_size <= 0) block_size = 4 << 20;
  int64_t nblocks = (n + block_size - 1) / block_size;
  if (nblocks == 0) nblocks = 1;
  return 16 + nblocks * 16 + n + nblocks * 64;
}

// Framing: u64 nblocks, u64 raw_total, then per block [u64 comp_len][data].
int64_t stpu_xbc_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap, int64_t block_size, int num_threads) {
  if (block_size <= 0) block_size = 4 << 20;
  int64_t nblocks = n == 0 ? 0 : (n + block_size - 1) / block_size;
  std::vector<std::vector<uint8_t>> comp((size_t)nblocks);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) num_threads(num_threads > 0 ? num_threads : omp_get_max_threads())
#endif
  for (int64_t b = 0; b < nblocks; ++b) {
    int64_t off = b * block_size;
    int64_t len = std::min(block_size, n - off);
    stpu::xbc_compress_block(src + off, len, comp[(size_t)b]);
  }
  int64_t total = 16;
  for (auto& c : comp) total += 8 + (int64_t)c.size();
  if (total > cap) return -2;
  put_u64(dst, (uint64_t)nblocks);
  put_u64(dst + 8, (uint64_t)n);
  int64_t w = 16;
  for (auto& c : comp) {
    put_u64(dst + w, (uint64_t)c.size());
    w += 8;
    std::memcpy(dst + w, c.data(), c.size());
    w += (int64_t)c.size();
  }
  return w;
}

// returns raw size, or <0 on error
int64_t stpu_xbc_decompressed_size(const uint8_t* src, int64_t n) {
  if (n < 16) return -1;
  return (int64_t)get_u64(src + 8);
}

int64_t stpu_xbc_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int num_threads) try {
  if (n < 16) return -1;
  int64_t nblocks = (int64_t)get_u64(src);
  int64_t raw_total = (int64_t)get_u64(src + 8);
  // every block occupies >= 8 (length) + 5 (header) wire bytes, so a claim
  // beyond n/13 blocks cannot be honest — reject before sizing the tables
  if (nblocks < 0 || nblocks > n / 13 + 1) return -1;
  if (raw_total < 0 || raw_total > cap) return -2;
  // scan block table (sequential), then decode in parallel
  std::vector<const uint8_t*> bptr((size_t)nblocks);
  std::vector<int64_t> blen((size_t)nblocks), boff((size_t)nblocks);
  int64_t r = 16, out_off = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    if (r + 8 > n) return -1;
    int64_t clen = (int64_t)get_u64(src + r);
    r += 8;
    if (r + clen > n || clen < 5) return -1;
    bptr[(size_t)b] = src + r;
    blen[(size_t)b] = clen;
    boff[(size_t)b] = out_off;
    // raw_len is bytes 1..4 of the block header
    uint32_t rl = (uint32_t)bptr[(size_t)b][1] | ((uint32_t)bptr[(size_t)b][2] << 8) |
                  ((uint32_t)bptr[(size_t)b][3] << 16) |
                  ((uint32_t)bptr[(size_t)b][4] << 24);
    out_off += rl;
    r += clen;
  }
  if (out_off != raw_total) return -1;
  volatile bool ok = true;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) num_threads(num_threads > 0 ? num_threads : omp_get_max_threads())
#endif
  for (int64_t b = 0; b < nblocks; ++b) {
    int64_t got = stpu::xbc_decompress_block(bptr[(size_t)b], blen[(size_t)b],
                                             dst + boff[(size_t)b],
                                             raw_total - boff[(size_t)b]);
    if (got < 0) ok = false;
  }
  if (!ok) return -1;
  return raw_total;
} catch (...) {
  return -1;
}

int64_t stpu_id_compress(const uint8_t* ids, const uint32_t* lens, uint32_t count,
                         uint8_t* dst, int64_t cap) {
  std::vector<uint8_t> out;
  int64_t n = stpu::id_compress_block(ids, lens, count, out);
  if (n < 0) return n;
  if (n > cap) return -2;
  std::memcpy(dst, out.data(), (size_t)n);
  return n;
}

// Decompressors handle untrusted wires: an allocation failure provoked by a
// hostile size claim must come back as -1 across the ctypes boundary, not as
// an uncaught std::bad_alloc aborting the process.

// fills dst with concatenated ids and lens_out with per-id lengths;
// returns total bytes, count via *count_out.
int64_t stpu_id_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap, uint32_t* lens_out, int64_t lens_cap,
                           uint32_t* count_out) try {
  std::vector<uint8_t> out;
  std::vector<uint32_t> lens;
  int64_t got = stpu::id_decompress_block(src, n, out, lens);
  if (got < 0) return got;
  if ((int64_t)out.size() > cap || (int64_t)lens.size() > lens_cap) return -2;
  std::memcpy(dst, out.data(), out.size());
  std::memcpy(lens_out, lens.data(), lens.size() * sizeof(uint32_t));
  *count_out = (uint32_t)lens.size();
  return got;
} catch (...) {
  return -1;
}

int stpu_version() { return 1; }
}
