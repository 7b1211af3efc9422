// xbc — the spring-tpu general-purpose block entropy codec.
//
// Reference analog: libbsc as Spring uses it (BWT + QLFC-static, no LZP;
// src/libbsc/bsc.cpp:785-786, block loop src/libbsc/libbsc/libbsc.cpp).
// From-scratch design: SA-IS BWT, compact-alphabet move-to-front, RLE0
// (Elias-gamma run lengths), and a context-modeled adaptive binary range
// coder. One call = one block; multi-block framing lives in Python
// (codecs/bsc.py) and OpenMP parallelism across blocks here.
//
// Wire format of one compressed block:
//   u8  mode          (0 = raw/stored, 1 = bwt+mtf+rc)
//   u32 raw_len
//   mode 1: u32 primary_index, 32B alphabet bitmap, rc stream
//   mode 0: raw bytes
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "rangecoder.h"
#include "sais.h"

namespace stpu {

namespace {

inline void put_u32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((uint8_t)x);
  v.push_back((uint8_t)(x >> 8));
  v.push_back((uint8_t)(x >> 16));
  v.push_back((uint8_t)(x >> 24));
}

inline uint32_t get_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// runtime-depth adaptive bit tree (alphabet of up to 256 symbols)
struct DynBitTree {
  std::vector<uint16_t> probs;
  int nbits;
  explicit DynBitTree(int bits) : probs((size_t)1 << (bits + 1), kProbInit), nbits(bits) {}
  inline void encode(RangeEncoder& rc, uint32_t sym) {
    uint32_t node = 1;
    for (int i = nbits - 1; i >= 0; --i) {
      int bit = (sym >> i) & 1;
      rc.encode_bit(&probs[node], bit);
      node = (node << 1) | bit;
    }
  }
  inline uint32_t decode(RangeDecoder& rc) {
    uint32_t node = 1;
    for (int i = 0; i < nbits; ++i) node = (node << 1) | rc.decode_bit(&probs[node]);
    return node - (1u << nbits);
  }
};

inline int rank_bucket(uint32_t r) {
  // bucket of the previous nonzero MTF rank, used as coding context
  if (r <= 2) return (int)r - 1;   // rank 1, 2 -> 0, 1
  if (r <= 4) return 2;
  if (r <= 7) return 3;
  if (r <= 15) return 4;
  return 5;
}

constexpr int kNumBuckets = 6;
constexpr int kRunCtx = 24;

struct Model {
  uint16_t is_zero[2 * kNumBuckets];           // ctx: prev-was-run x bucket
  uint16_t run_len_unary[kRunCtx];             // gamma: unary length prefix
  uint16_t run_len_bits[kRunCtx];              // gamma: mantissa bits
  std::vector<DynBitTree> rank_trees;          // per-bucket rank coder

  explicit Model(int alpha_bits) {
    for (auto& p : is_zero) p = kProbInit;
    for (auto& p : run_len_unary) p = kProbInit;
    for (auto& p : run_len_bits) p = kProbInit;
    rank_trees.reserve(kNumBuckets);
    for (int i = 0; i < kNumBuckets; ++i) rank_trees.emplace_back(alpha_bits);
  }
};

inline int bit_length(uint32_t v) {
  int k = 0;
  while (v) {
    ++k;
    v >>= 1;
  }
  return k;
}

void bwt_forward(const uint8_t* data, int32_t n, uint8_t* out, uint32_t* primary) {
  std::vector<int32_t> sa((size_t)n + 1);
  suffix_array_u8(data, n, sa.data());
  int32_t k = 0;
  for (int32_t i = 0; i <= n; ++i) {
    int32_t j = sa[i];
    if (j == 0) {
      *primary = (uint32_t)i;  // row of the full-string suffix (the '$' cell)
      continue;
    }
    out[k++] = data[j - 1];
  }
}

void bwt_inverse(const uint8_t* L, int32_t n, uint32_t primary, uint8_t* out) {
  // LF-walk from the sentinel row, emitting the text back-to-front.
  std::vector<int32_t> rank((size_t)n);
  int32_t cnt[256] = {0};
  for (int32_t i = 0; i < n; ++i) {
    rank[i] = cnt[L[i]]++;
  }
  int32_t tot[256];
  int32_t sum = 1;  // row 0 of the first column is the sentinel
  for (int c = 0; c < 256; ++c) {
    tot[c] = sum;
    sum += cnt[c];
  }
  int64_t r = 0;  // row in the (n+1)-row conceptual matrix; row 0 = '$' suffix
  for (int32_t k = n - 1; k >= 0; --k) {
    int64_t i = r - (r > (int64_t)primary ? 1 : 0);  // index into L
    uint8_t c = L[i];
    out[k] = c;
    r = tot[c] + rank[i];
  }
}

void encode_mtf_rc(const uint8_t* bwt, int32_t n, std::vector<uint8_t>& out) {
  // compact alphabet
  bool present[256] = {false};
  for (int32_t i = 0; i < n; ++i) present[bwt[i]] = true;
  uint8_t to_sym[256];
  uint8_t mtf[256];
  int m = 0;
  for (int c = 0; c < 256; ++c)
    if (present[c]) {
      to_sym[c] = (uint8_t)m;
      mtf[m] = (uint8_t)m;
      ++m;
    }
  // alphabet bitmap
  for (int b = 0; b < 32; ++b) {
    uint8_t byte = 0;
    for (int j = 0; j < 8; ++j)
      if (present[b * 8 + j]) byte |= (uint8_t)(1 << j);
    out.push_back(byte);
  }
  int alpha_bits = std::max(1, bit_length((uint32_t)(m - 1)));

  Model mdl(alpha_bits);
  RangeEncoder rc(&out);
  int prev_bucket = 0;
  int prev_was_run = 0;
  int32_t i = 0;
  // MTF inline: mtf[] maps rank -> symbol
  while (i < n) {
    uint8_t sym = to_sym[bwt[i]];
    // find rank
    int r = 0;
    while (mtf[r] != sym) ++r;
    int zctx = prev_was_run * kNumBuckets + prev_bucket;
    if (r == 0) {
      rc.encode_bit(&mdl.is_zero[zctx], 0);
      // count run of the same symbol
      int64_t run = 1;
      while (i + run < n && bwt[i + run] == bwt[i]) ++run;
      i += run;
      // Elias gamma: k = bit_length(run), unary k then k-1 mantissa bits
      int k = bit_length((uint32_t)run);
      for (int j = 0; j < k - 1; ++j)
        rc.encode_bit(&mdl.run_len_unary[std::min(j, kRunCtx - 1)], 1);
      rc.encode_bit(&mdl.run_len_unary[std::min(k - 1, kRunCtx - 1)], 0);
      for (int j = k - 2; j >= 0; --j)
        rc.encode_bit(&mdl.run_len_bits[std::min(j, kRunCtx - 1)],
                      (int)((run >> j) & 1));
      prev_was_run = 1;
    } else {
      rc.encode_bit(&mdl.is_zero[zctx], 1);
      mdl.rank_trees[prev_bucket].encode(rc, (uint32_t)(r - 1));
      // move to front
      for (int j = r; j > 0; --j) mtf[j] = mtf[j - 1];
      mtf[0] = sym;
      prev_bucket = rank_bucket((uint32_t)r);
      prev_was_run = 0;
      ++i;
    }
  }
  rc.flush();
}

int32_t decode_mtf_rc(const uint8_t* in, size_t in_len, int32_t n, uint8_t* out) {
  // alphabet bitmap
  uint8_t mtf[256];
  uint8_t from_sym[256];
  int m = 0;
  for (int b = 0; b < 32; ++b) {
    uint8_t byte = in[b];
    for (int j = 0; j < 8; ++j)
      if (byte & (1 << j)) {
        from_sym[m] = (uint8_t)(b * 8 + j);
        mtf[m] = (uint8_t)m;
        ++m;
      }
  }
  int alpha_bits = std::max(1, bit_length((uint32_t)(m - 1)));
  Model mdl(alpha_bits);
  RangeDecoder rc(in + 32, in_len - 32);
  int prev_bucket = 0;
  int prev_was_run = 0;
  int32_t i = 0;
  while (i < n) {
    int zctx = prev_was_run * kNumBuckets + prev_bucket;
    int nz = rc.decode_bit(&mdl.is_zero[zctx]);
    if (!nz) {
      int k = 1;
      while (rc.decode_bit(&mdl.run_len_unary[std::min(k - 1, kRunCtx - 1)])) ++k;
      int64_t run = 1;
      for (int j = k - 2; j >= 0; --j)
        run = (run << 1) | rc.decode_bit(&mdl.run_len_bits[std::min(j, kRunCtx - 1)]);
      if (i + run > n) return -1;
      uint8_t c = from_sym[mtf[0]];
      for (int64_t j = 0; j < run; ++j) out[i + j] = c;
      i += run;
      prev_was_run = 1;
    } else {
      int r = (int)mdl.rank_trees[prev_bucket].decode(rc) + 1;
      if (r >= m) return -1;
      uint8_t sym = mtf[r];
      for (int j = r; j > 0; --j) mtf[j] = mtf[j - 1];
      mtf[0] = sym;
      out[i++] = from_sym[sym];
      prev_bucket = rank_bucket((uint32_t)r);
      prev_was_run = 0;
    }
  }
  return i;
}

}  // namespace

int64_t xbc_compress_block(const uint8_t* src, int64_t n, std::vector<uint8_t>& out) {
  out.clear();
  if (n < 64) {
    out.push_back(0);
    put_u32(out, (uint32_t)n);
    out.insert(out.end(), src, src + n);
    return (int64_t)out.size();
  }
  out.push_back(1);
  put_u32(out, (uint32_t)n);
  std::vector<uint8_t> bwt((size_t)n);
  uint32_t primary = 0;
  bwt_forward(src, (int32_t)n, bwt.data(), &primary);
  put_u32(out, primary);
  encode_mtf_rc(bwt.data(), (int32_t)n, out);
  if ((int64_t)out.size() >= n + 5) {  // incompressible: store raw
    out.clear();
    out.push_back(0);
    put_u32(out, (uint32_t)n);
    out.insert(out.end(), src, src + n);
  }
  return (int64_t)out.size();
}

int64_t xbc_decompress_block(const uint8_t* src, int64_t in_len, uint8_t* dst,
                             int64_t dst_cap) {
  if (in_len < 5) return -1;
  uint8_t mode = src[0];
  int64_t n = (int64_t)get_u32(src + 1);
  if (n > dst_cap) return -2;
  if (mode == 0) {
    if (in_len < 5 + n) return -1;
    std::memcpy(dst, src + 5, (size_t)n);
    return n;
  }
  if (mode != 1 || in_len < 9 + 32) return -1;
  uint32_t primary = get_u32(src + 5);
  std::vector<uint8_t> bwt((size_t)n);
  if (decode_mtf_rc(src + 9, (size_t)(in_len - 9), (int32_t)n, bwt.data()) != n)
    return -1;
  bwt_inverse(bwt.data(), (int32_t)n, primary, dst);
  return n;
}

}  // namespace stpu
