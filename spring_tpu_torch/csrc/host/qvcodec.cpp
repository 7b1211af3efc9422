// qvcodec — dedicated quality-score codec (context-modeled adaptive
// range coding).
//
// Reference analog: Spring entropy-codes quality strings with generic
// libbsc (BWT + QLFC, src/reorder_compress_quality_id.cpp:170-183).
// Quality data has strong *local* structure — q[i] correlates with
// q[i-1], q[i-2] and the position in the read — which a direct
// context-mixed coder captures better than a block-sorting transform,
// at a fraction of the CPU cost (no suffix array). This is the design
// family of the FASTQ-specialized coders (fqzcomp et al.), implemented
// from scratch on spring-tpu's shared binary range coder.
//
// Model: the quality alphabet of the block is made dense (A symbols,
// coded as ceil(log2 A)-bit adaptive trees); the tree is selected by
//   ctx = (q1, quant8(q2), quant16(pos))
// where q1 is the previous symbol (halved if A > 64), q2 the one before,
// and pos the position scaled by the block's max read length.
//
// Input rows are concatenated (ragged) so arbitrarily long reads work.
//
// Wire format: u32 shard count S, then per shard [u64 comp_len][payload].
// Rows are split into S char-balanced contiguous shards, each encoded as
// an independent range-coded stream (own model + alphabet), so decode is
// S-way parallel — an adaptive range coder is inherently serial within a
// stream, and this is what bounds decompression latency per block.
// Shard payload: u32 n, u32 Lmax, u64 total, u32 checksum (FNV-1a of the
// shard's raw chars, validated on decode — reference parity: libbsc's
// adler32), 32-byte alphabet bitmap, rc stream of [per read: len
// (same-as-prev bit, else adaptive gamma), symbols].
//
// Constant-prefix fast path (Lmax bit 30): when every row is a prefix of
// one master row — the shape QVZ-collapsed quality takes at low rate
// targets — the payload is the raw master row + the range-coded length
// stream only. The adaptive coder's probability ceiling costs ~0.045
// bits/sym even on fully deterministic input, which is 100x the size of
// just shipping the master row once.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#include "rangecoder.h"

namespace stpu {

namespace {

inline int bit_len(uint32_t v) {
  int k = 0;
  while (v) {
    ++k;
    v >>= 1;
  }
  return k;
}

struct QVModel {
  int A = 1;        // alphabet size
  int abits = 1;    // tree depth
  int tsz = 2;      // probs per tree (1 << abits)
  int q1n = 1;      // q1 context cardinality
  int posn = 16;    // position-context buckets (finer for small alphabets:
                    // quantized data is near-deterministic per COLUMN, and
                    // 16 buckets left ~0.04 bits/sym of per-column
                    // structure unmodeled on qvz-quantized input)
  std::vector<uint16_t> trees;  // q1n*8*posn trees of tsz probs
  uint16_t len_same[2];
  std::vector<uint16_t> len_tree;  // 32-bit adaptive tree

  void init(int alpha, bool fine_pos) {
    A = std::max(alpha, 1);
    abits = std::max(bit_len((uint32_t)(A - 1)), 1);
    tsz = 1 << abits;
    q1n = A <= 64 ? A : (A + 1) / 2;
    // fine position contexts for quantizer output (near-deterministic per
    // column — the caller flags it) and for tiny alphabets; natural
    // quality data (8+ levels) is noisy and fine contexts dilute its
    // statistics (measured +1.2% on 8-level data at 128 buckets)
    posn = (fine_pos || A <= 6) ? 128 : 16;
    trees.assign((size_t)q1n * 8 * posn * tsz, kProbInit);
    len_same[0] = len_same[1] = kProbInit;
    // lengths: 5-bit bit-count tree + per-position mantissa probs
    len_tree.assign(32 + 32, kProbInit);
  }

  inline uint16_t* ctx_tree(int q1, int q2, int posb) {
    int q1c = A <= 64 ? q1 : (q1 >> 1);
    int q2b = (q2 * 8) / A;  // A >= 1
    return trees.data() + (((size_t)q1c * 8 + q2b) * posn + posb) * tsz;
  }
};

inline void tree_encode(RangeEncoder& rc, uint16_t* probs, int nbits,
                        uint32_t sym) {
  uint32_t node = 1;
  for (int i = nbits - 1; i >= 0; --i) {
    int bit = (sym >> i) & 1;
    rc.encode_bit(&probs[node], bit);
    node = (node << 1) | bit;
  }
}

inline uint32_t tree_decode(RangeDecoder& rc, uint16_t* probs, int nbits) {
  uint32_t node = 1;
  for (int i = 0; i < nbits; ++i) node = (node << 1) | rc.decode_bit(&probs[node]);
  return node - (1u << nbits);
}

// Elias-gamma-style adaptive length coder (lengths can exceed 16 bits in
// long mode): 5-bit bit-count tree, then adaptive mantissa bits.
inline void len_encode(RangeEncoder& rc, QVModel& m, uint32_t v) {
  int k = bit_len(v);  // v >= 0; k in 0..32
  tree_encode(rc, m.len_tree.data(), 5, (uint32_t)k);
  for (int j = k - 2; j >= 0; --j)
    rc.encode_bit(&m.len_tree[32 + j], (int)((v >> j) & 1));
}

inline uint32_t len_decode(RangeDecoder& rc, QVModel& m) {
  int k = (int)tree_decode(rc, m.len_tree.data(), 5);
  if (k == 0) return 0;
  uint32_t v = 1;
  for (int j = k - 2; j >= 0; --j)
    v = (v << 1) | rc.decode_bit(&m.len_tree[32 + j]);
  return v;
}

inline void put_u32p(uint8_t* p, uint32_t x) {
  p[0] = (uint8_t)x;
  p[1] = (uint8_t)(x >> 8);
  p[2] = (uint8_t)(x >> 16);
  p[3] = (uint8_t)(x >> 24);
}

inline uint32_t get_u32p(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline uint32_t fnv1a(const uint8_t* p, int64_t n) {
  uint32_t h = 2166136261u;
  for (int64_t i = 0; i < n; ++i) {
    h ^= p[i];
    h *= 16777619u;
  }
  return h;
}

constexpr int kHdr = 20 + 32;

}  // namespace

// blob: concatenated rows, lens[r] chars each. One shard (serial stream).
static int64_t qv_compress_one(const uint8_t* blob, int64_t n,
                               const int32_t* lens, std::vector<uint8_t>& out,
                               bool fine_pos) {
  out.clear();
  out.resize(kHdr, 0);
  int64_t total = 0;
  int64_t Lmax = 0;
  for (int64_t r = 0; r < n; ++r) {
    total += lens[r];
    Lmax = std::max<int64_t>(Lmax, lens[r]);
  }
  if (Lmax >= (int64_t)1 << 30) return -4;  // bits 30/31 are flags
  // constant-prefix detection: is every row a prefix of one master row?
  const uint8_t* master = nullptr;
  if (n > 0 && Lmax > 0) {
    const uint8_t* p = blob;
    for (int64_t r = 0; r < n; ++r) {
      if (lens[r] == Lmax) {
        master = p;
        break;
      }
      p += lens[r];
    }
    p = blob;
    for (int64_t r = 0; r < n && master; ++r) {
      if (std::memcmp(p, master, (size_t)lens[r]) != 0) master = nullptr;
      p += lens[r];
    }
  }
  put_u32p(out.data(), (uint32_t)n);
  // Lmax bit 31 carries the fine-position-context flag, bit 30 const-prefix
  put_u32p(out.data() + 4, (uint32_t)Lmax | (fine_pos ? 0x80000000u : 0u) |
                               (master ? 0x40000000u : 0u));
  for (int i = 0; i < 8; ++i) out[8 + i] = (uint8_t)((uint64_t)total >> (8 * i));
  put_u32p(out.data() + 16, fnv1a(blob, total));
  bool present[256] = {false};
  for (int64_t i = 0; i < total; ++i) present[blob[i]] = true;
  uint8_t dense[256] = {0};
  int A = 0;
  for (int c = 0; c < 256; ++c)
    if (present[c]) {
      out[20 + c / 8] |= (uint8_t)(1 << (c % 8));
      dense[c] = (uint8_t)A++;
    }
  if (n == 0) return (int64_t)out.size();
  if (master) {
    out.insert(out.end(), master, master + Lmax);
    QVModel mdl;
    mdl.init(A, fine_pos);
    RangeEncoder rc(&out);
    int32_t prev_len = -1;
    for (int64_t r = 0; r < n; ++r) {
      int32_t len = lens[r];
      if (len == prev_len) {
        rc.encode_bit(&mdl.len_same[0], 0);
      } else {
        rc.encode_bit(&mdl.len_same[0], 1);
        len_encode(rc, mdl, (uint32_t)len);
        prev_len = len;
      }
    }
    rc.flush();
    return (int64_t)out.size();
  }

  QVModel mdl;
  mdl.init(A, fine_pos);
  RangeEncoder rc(&out);
  int32_t prev_len = -1;
  int64_t Lm = std::max<int64_t>(Lmax, 1);
  const uint8_t* row = blob;
  for (int64_t r = 0; r < n; ++r) {
    int32_t len = lens[r];
    if (len == prev_len) {
      rc.encode_bit(&mdl.len_same[0], 0);
    } else {
      rc.encode_bit(&mdl.len_same[0], 1);
      len_encode(rc, mdl, (uint32_t)len);
      prev_len = len;
    }
    int q1 = 0, q2 = 0;
    for (int32_t i = 0; i < len; ++i) {
      int d = dense[row[i]];
      int posb = (int)(((int64_t)i * mdl.posn) / Lm);
      if (posb > mdl.posn - 1) posb = mdl.posn - 1;
      tree_encode(rc, mdl.ctx_tree(q1, q2, posb), mdl.abits, (uint32_t)d);
      q2 = q1;
      q1 = d;
    }
    row += len;
  }
  rc.flush();
  return (int64_t)out.size();
}

static int64_t qv_decompress_one(const uint8_t* src, int64_t src_len,
                                 uint8_t* blob, int64_t blob_cap,
                                 int32_t* lens, int64_t n_cap) {
  if (src_len < kHdr) return -1;
  int64_t n = (int64_t)get_u32p(src);
  uint64_t total = 0;
  for (int i = 0; i < 8; ++i) total |= (uint64_t)src[8 + i] << (8 * i);
  if (n > n_cap || (int64_t)total > blob_cap) return -2;
  uint32_t lraw = get_u32p(src + 4);
  bool fine_pos = (lraw >> 31) != 0;
  bool const_prefix = (lraw >> 30) & 1;
  int64_t Lmax = (int64_t)(lraw & 0x3FFFFFFFu);
  uint8_t from_dense[256];
  int A = 0;
  for (int c = 0; c < 256; ++c)
    if (src[20 + c / 8] & (1 << (c % 8))) from_dense[A++] = (uint8_t)c;
  if (n == 0) return 0;
  if (A == 0 && total > 0) return -1;
  if (A == 0) {
    std::memset(lens, 0, (size_t)n * sizeof(int32_t));
    return n;
  }

  if (const_prefix) {
    if (src_len < kHdr + Lmax) return -1;
    const uint8_t* master = src + kHdr;
    QVModel mdl;
    mdl.init(A, fine_pos);
    RangeDecoder rc(src + kHdr + Lmax, (size_t)(src_len - kHdr - Lmax));
    int32_t prev_len = -1;
    uint8_t* row = blob;
    int64_t written = 0;
    for (int64_t r = 0; r < n; ++r) {
      int32_t len = prev_len;
      if (rc.decode_bit(&mdl.len_same[0])) {
        len = (int32_t)len_decode(rc, mdl);
        prev_len = len;
      }
      if (len < 0 || len > Lmax || written + len > (int64_t)total) return -1;
      lens[r] = len;
      std::memcpy(row, master, (size_t)len);
      row += len;
      written += len;
    }
    if (written != (int64_t)total) return -1;
    if (fnv1a(blob, (int64_t)total) != get_u32p(src + 16)) return -3;
    return n;
  }

  QVModel mdl;
  mdl.init(A, fine_pos);
  RangeDecoder rc(src + kHdr, (size_t)(src_len - kHdr));
  int32_t prev_len = -1;
  int64_t Lm = std::max<int64_t>(Lmax, 1);
  uint8_t* row = blob;
  int64_t written = 0;
  for (int64_t r = 0; r < n; ++r) {
    int32_t len = prev_len;
    if (rc.decode_bit(&mdl.len_same[0])) {
      len = (int32_t)len_decode(rc, mdl);
      prev_len = len;
    }
    if (len < 0 || written + len > (int64_t)total) return -1;
    lens[r] = len;
    int q1 = 0, q2 = 0;
    for (int32_t i = 0; i < len; ++i) {
      int posb = (int)(((int64_t)i * mdl.posn) / Lm);
      if (posb > mdl.posn - 1) posb = mdl.posn - 1;
      uint32_t d = tree_decode(rc, mdl.ctx_tree(q1, q2, posb), mdl.abits);
      if ((int)d >= A) return -1;
      row[i] = from_dense[d];
      q2 = q1;
      q1 = (int)d;
    }
    row += len;
    written += len;
  }
  if (written != (int64_t)total) return -1;
  if (fnv1a(blob, (int64_t)total) != get_u32p(src + 16)) return -3;
  return n;
}

namespace {

constexpr int64_t kShardChars = 4 << 20;  // target raw chars per shard
constexpr int kMaxShards = 16;

inline uint64_t get_u64p(const uint8_t* p) {
  uint64_t x = 0;
  for (int i = 0; i < 8; ++i) x |= (uint64_t)p[i] << (8 * i);
  return x;
}

// walk the shard framing; fills per-shard (src_off, src_len, n, total).
// Returns S, or -1 on corrupt framing.
struct ShardRef {
  int64_t off, len, n, total;
};

int shard_walk(const uint8_t* src, int64_t src_len, ShardRef* refs) {
  if (src_len < 4) return -1;
  int S = (int)get_u32p(src);
  if (S < 0 || S > kMaxShards) return -1;
  int64_t p = 4;
  for (int s = 0; s < S; ++s) {
    if (p + 8 > src_len) return -1;
    int64_t clen = (int64_t)get_u64p(src + p);
    p += 8;
    if (clen < kHdr || p + clen > src_len) return -1;
    refs[s].off = p;
    refs[s].len = clen;
    refs[s].n = (int64_t)get_u32p(src + p);
    refs[s].total = (int64_t)get_u64p(src + p + 8);
    p += clen;
  }
  return S;
}

}  // namespace

int64_t qv_compress(const uint8_t* blob, int64_t n, const int32_t* lens,
                    std::vector<uint8_t>& out, int num_threads,
                    bool fine_pos) {
  int64_t total = 0;
  for (int64_t r = 0; r < n; ++r) total += lens[r];
  int S = (int)std::min<int64_t>(
      std::min<int64_t>((total + kShardChars - 1) / kShardChars,
                        std::max<int64_t>(n, 1)),
      kMaxShards);
  if (S < 1) S = 1;
  // char-balanced contiguous row partition
  std::vector<int64_t> r0(S + 1, 0), b0(S + 1, 0);
  {
    int64_t target = (total + S - 1) / S;
    int64_t acc = 0, row = 0;
    for (int s = 1; s < S; ++s) {
      int64_t want = target * s;
      while (row < n && acc < want) acc += lens[row++];
      r0[s] = row;
      b0[s] = acc;
    }
    r0[S] = n;
    b0[S] = total;
  }
  std::vector<std::vector<uint8_t>> parts((size_t)S);
  bool fail = false;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) num_threads(num_threads > 0 ? std::min(num_threads, S) : std::min(S, omp_get_max_threads()))
#endif
  for (int s = 0; s < S; ++s) {
    if (qv_compress_one(blob + b0[s], r0[s + 1] - r0[s], lens + r0[s],
                        parts[s], fine_pos) < 0) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
      fail = true;
    }
  }
  if (fail) return -1;
  int64_t sz = 4;
  for (auto& p : parts) sz += 8 + (int64_t)p.size();
  out.resize((size_t)sz);
  put_u32p(out.data(), (uint32_t)S);
  int64_t w = 4;
  for (auto& p : parts) {
    uint64_t cl = (uint64_t)p.size();
    for (int i = 0; i < 8; ++i) out[w + i] = (uint8_t)(cl >> (8 * i));
    w += 8;
    std::memcpy(out.data() + w, p.data(), p.size());
    w += (int64_t)p.size();
  }
  return sz;
}

int64_t qv_decompress(const uint8_t* src, int64_t src_len, uint8_t* blob,
                      int64_t blob_cap, int32_t* lens, int64_t n_cap,
                      int num_threads) {
  ShardRef refs[kMaxShards];
  int S = shard_walk(src, src_len, refs);
  if (S < 0) return -1;
  int64_t n = 0, total = 0;
  for (int s = 0; s < S; ++s) {
    n += refs[s].n;
    total += refs[s].total;
  }
  if (n > n_cap || total > blob_cap) return -2;
  int64_t rv = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) num_threads(num_threads > 0 ? std::min(num_threads, std::max(S, 1)) : std::min(std::max(S, 1), omp_get_max_threads()))
#endif
  for (int s = 0; s < S; ++s) {
    int64_t nb = 0, bb = 0;
    for (int t = 0; t < s; ++t) {
      nb += refs[t].n;
      bb += refs[t].total;
    }
    int64_t got = qv_decompress_one(src + refs[s].off, refs[s].len, blob + bb,
                                    refs[s].total, lens + nb, refs[s].n);
    if (got != refs[s].n) {
#ifdef _OPENMP
#pragma omp critical
#endif
      rv = got < 0 ? got : -1;
    }
  }
  return rv < 0 ? rv : n;
}

}  // namespace stpu

extern "C" {

// compressed-size upper bound for the caller's dst buffer
int64_t stpu_qv_bound(int64_t total_chars, int64_t n) {
  return 256 + total_chars + n + 80 * 16;
}

int64_t stpu_qv_compress(const uint8_t* blob, int64_t n, const int32_t* lens,
                         uint8_t* dst, int64_t cap, int num_threads,
                         int fine_pos) {
  std::vector<uint8_t> out;
  int64_t sz = stpu::qv_compress(blob, n, lens, out, num_threads,
                                 fine_pos != 0);
  if (sz < 0) return sz;
  if (sz > cap) return -2;
  std::memcpy(dst, out.data(), (size_t)sz);
  return sz;
}

// header peek so the caller can size the outputs: fills n, Lmax, total
int stpu_qv_dims(const uint8_t* src, int64_t src_len, int64_t* n, int64_t* L,
                 int64_t* total) {
  stpu::ShardRef refs[stpu::kMaxShards];
  int S = stpu::shard_walk((const uint8_t*)src, src_len, refs);
  if (S < 0) return -1;
  int64_t nn = 0, tt = 0, LL = 0;
  for (int s = 0; s < S; ++s) {
    nn += refs[s].n;
    tt += refs[s].total;
    LL = std::max<int64_t>(
        LL, (int64_t)(stpu::get_u32p((const uint8_t*)src + refs[s].off + 4)
                      & 0x3FFFFFFFu));
  }
  *n = nn;
  *L = LL;
  *total = tt;
  return 0;
}

int64_t stpu_qv_decompress(const uint8_t* src, int64_t src_len, uint8_t* blob,
                           int64_t blob_cap, int32_t* lens, int64_t n_cap,
                           int num_threads) {
  return stpu::qv_decompress(src, src_len, blob, blob_cap, lens, n_cap,
                             num_threads);
}

}  // extern "C"
