// Tokenized read-identifier codec.
//
// Reference analog: src/id_compression/ (samcomp-derived): each id is
// tokenized and coded against the previous id's tokens with token types
// ALPHA/DIGIT/CHAR/MATCH/ZEROS/DELTA/END (src/id_compression/include/
// sam_block.h:81-89) through an adaptive arithmetic coder. This is a
// from-scratch equivalent on the shared binary range coder: ids are split
// into alternating digit / non-digit runs, each token coded as MATCH /
// DELTA(+k vs previous numeric token) / literal, with per-token-index
// adaptive models. Typical Illumina ids (fixed prefix + incrementing
// counter) cost well under a bit per id.
//
// Wire format: u32 count, rc stream.
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "rangecoder.h"

namespace stpu {

namespace {

constexpr int kMaxTokCtx = 16;

// T_DUP: byte-copy of an EARLIER digit token of the SAME id — SRA-style
// ids repeat the read number ("@SRR.{p} {p} length=..."), and coding the
// second occurrence against the previous id (as the reference's samcomp
// models do) pays the full literal cost per id in reordered mode.
enum TokType {
  T_END = 0,
  T_MATCH = 1,
  T_DELTA = 2,
  T_LIT_DIGIT = 3,
  T_LIT_OTHER = 4,
  T_DUP = 5
};

struct Token {
  bool is_digit;
  const uint8_t* p;
  uint32_t len;
  uint64_t value;     // parsed numeric value (digit tokens with len<=18)
  bool has_value;
};

void tokenize(const uint8_t* s, uint32_t n, std::vector<Token>& toks) {
  toks.clear();
  uint32_t i = 0;
  while (i < n) {
    bool d = s[i] >= '0' && s[i] <= '9';
    uint32_t j = i;
    while (j < n && ((s[j] >= '0' && s[j] <= '9') == d)) ++j;
    Token t{d, s + i, j - i, 0, false};
    if (d && t.len <= 18) {
      uint64_t v = 0;
      for (uint32_t k = i; k < j; ++k) v = v * 10 + (s[k] - '0');
      t.value = v;
      t.has_value = true;
    }
    toks.push_back(t);
    i = j;
  }
}

// format check: does `value` render back to exactly the token's bytes given
// the previous token's width (to preserve zero padding)?
bool delta_representable(const Token& prev, const Token& cur, uint64_t* delta) {
  if (!prev.has_value || !cur.has_value) return false;
  if (cur.value < prev.value) return false;
  uint64_t d = cur.value - prev.value;
  if (d > 65535) return false;
  // exact re-rendering: same length means same zero padding; different
  // length only allowed when cur has no leading zero (natural growth)
  if (cur.len == prev.len) {
    *delta = d;
    return true;
  }
  if (cur.len > prev.len && cur.p[0] != '0' && prev.p[0] != '0') {
    *delta = d;
    return true;
  }
  return false;
}

// simple fixed-depth tree coders over a prob slab. Ids are
// near-deterministic streams (fixed prefix + incrementing counters), so
// they use the high-precision probabilities: the 12-bit adaptation floor
// alone cost 0.30 bits/id on sequential ids (see rangecoder.h)
inline void tree_encode(RangeEncoder& rc, uint16_t* probs, int nbits, uint32_t sym) {
  uint32_t node = 1;
  for (int i = nbits - 1; i >= 0; --i) {
    int bit = (sym >> i) & 1;
    rc.encode_bit_pb<kProbBitsHi>(&probs[node], bit);
    node = (node << 1) | bit;
  }
}

inline uint32_t tree_decode(RangeDecoder& rc, uint16_t* probs, int nbits) {
  uint32_t node = 1;
  for (int i = 0; i < nbits; ++i)
    node = (node << 1) | rc.decode_bit_pb<kProbBitsHi>(&probs[node]);
  return node - (1u << nbits);
}

// Count-based (KT-estimator) bit models for the id token streams: ids are
// near-stationary per block, where EMA probabilities pay a constant
// oscillation/floor tax per event (~0.3 bits/id on permuted counters, the
// measured gap to the reference's count-based samcomp models). Counts are
// packed c0|c1<<16 and halved on u16 saturation; p0 = (2*c0+1)/(2*n+2)
// computed per event (one u64 division — ids are a tiny runtime slice).
inline uint32_t count_prob(uint32_t cnt) {
  uint32_t c0 = cnt & 0xFFFFu, c1 = cnt >> 16;
  uint32_t p = (uint32_t)((((uint64_t)(2 * c0 + 1)) << kProbBitsHi) /
                          (2 * (uint64_t)(c0 + c1) + 2));
  if (p == 0) p = 1;
  if (p >= (1u << kProbBitsHi)) p = (1u << kProbBitsHi) - 1;
  return p;
}

inline uint32_t count_update(uint32_t cnt, int bit) {
  uint32_t c0 = cnt & 0xFFFFu, c1 = cnt >> 16;
  if (bit) ++c1; else ++c0;
  if (c0 >= 0xFFFFu || c1 >= 0xFFFFu) {
    c0 = (c0 + 1) >> 1;
    c1 = (c1 + 1) >> 1;
  }
  return c0 | (c1 << 16);
}

inline void encode_bit_cnt(RangeEncoder& rc, uint32_t* cnt, int bit) {
  uint32_t bound = (rc.range >> kProbBitsHi) * count_prob(*cnt);
  if (!bit) {
    rc.range = bound;
  } else {
    rc.low += bound;
    rc.range -= bound;
  }
  *cnt = count_update(*cnt, bit);
  while (rc.range < kTopValue) {
    rc.range <<= 8;
    rc.shift_low();
  }
}

inline int decode_bit_cnt(RangeDecoder& rc, uint32_t* cnt) {
  uint32_t bound = (rc.range >> kProbBitsHi) * count_prob(*cnt);
  int bit;
  if (rc.code < bound) {
    rc.range = bound;
    bit = 0;
  } else {
    rc.code -= bound;
    rc.range -= bound;
    bit = 1;
  }
  *cnt = count_update(*cnt, bit);
  while (rc.range < kTopValue) {
    rc.range <<= 8;
    rc.code = (rc.code << 8) | rc.next_byte();
  }
  return bit;
}

inline void tree_encode_cnt(RangeEncoder& rc, uint32_t* cnts, int nbits,
                            uint32_t sym) {
  uint32_t node = 1;
  for (int i = nbits - 1; i >= 0; --i) {
    int bit = (sym >> i) & 1;
    encode_bit_cnt(rc, &cnts[node], bit);
    node = (node << 1) | bit;
  }
}

inline uint32_t tree_decode_cnt(RangeDecoder& rc, uint32_t* cnts, int nbits) {
  uint32_t node = 1;
  for (int i = 0; i < nbits; ++i)
    node = (node << 1) | decode_bit_cnt(rc, &cnts[node]);
  return node - (1u << nbits);
}

struct Models {
  // per token-index models (type/len/digit trees use count-based bit
  // models; chr literals and the gamma helpers keep EMA probabilities)
  std::vector<uint32_t> type_c;   // 3-bit tree -> 8 nodes... use 8 slots
  std::vector<uint32_t> len_c;    // 8-bit tree -> 256... use 512 slots
  std::vector<uint16_t> chr_p;    // 8-bit tree per token index (literal chars)
  std::vector<uint32_t> dig_c;    // 4-bit tree per (token index, token len,
                                  // digit pos): for a permuted counter the
                                  // digit distribution reaches the value
                                  // entropy only conditioned on BOTH length
                                  // and position (pooled-position models
                                  // cap 0.3 bits/id above the bound; one
                                  // shared model a further ~0.7 above)
  std::vector<uint16_t> dlt_p;    // 17-bit... too big; use gamma coding probs
  std::vector<uint16_t> dlt_unary, dlt_bits;
  std::vector<uint16_t> dup_unary, dup_bits;
  Models()
      : type_c((size_t)kMaxTokCtx * 8, 0),
        len_c((size_t)kMaxTokCtx * 512, 0),
        chr_p((size_t)kMaxTokCtx * 512, kProbInitHi),
        dig_c((size_t)kMaxTokCtx * 8 * 8 * 32, 0),
        dlt_unary((size_t)kMaxTokCtx * 20, kProbInitHi),
        dlt_bits((size_t)kMaxTokCtx * 20, kProbInitHi),
        dup_unary((size_t)kMaxTokCtx * 8, kProbInitHi),
        dup_bits((size_t)kMaxTokCtx * 8, kProbInitHi) {}
};

inline int bit_len(uint64_t v) {
  int k = 0;
  while (v) {
    ++k;
    v >>= 1;
  }
  return k;
}

// gamma-code v (v >= 0): code v+1
inline void gamma_encode(RangeEncoder& rc, uint16_t* unary, uint16_t* bits,
                         int nctx, uint64_t v) {
  uint64_t x = v + 1;
  int k = bit_len(x);
  for (int j = 0; j < k - 1; ++j)
    rc.encode_bit_pb<kProbBitsHi>(&unary[j < nctx ? j : nctx - 1], 1);
  rc.encode_bit_pb<kProbBitsHi>(&unary[(k - 1) < nctx ? (k - 1) : nctx - 1], 0);
  for (int j = k - 2; j >= 0; --j)
    rc.encode_bit_pb<kProbBitsHi>(&bits[j < nctx ? j : nctx - 1], (int)((x >> j) & 1));
}

inline uint64_t gamma_decode(RangeDecoder& rc, uint16_t* unary, uint16_t* bits,
                             int nctx) {
  int k = 1;
  while (rc.decode_bit_pb<kProbBitsHi>(&unary[(k - 1) < nctx ? (k - 1) : nctx - 1])) ++k;
  uint64_t x = 1;
  for (int j = k - 2; j >= 0; --j)
    x = (x << 1) | (uint64_t)rc.decode_bit_pb<kProbBitsHi>(&bits[j < nctx ? j : nctx - 1]);
  return x - 1;
}

void encode_literal(RangeEncoder& rc, Models& m, int ti, const Token& t) {
  // length via 8-bit tree (lengths >= 255 escape to gamma)
  uint32_t* lp = &m.len_c[(size_t)ti * 512];
  uint32_t l = t.len < 255 ? t.len : 255;
  tree_encode_cnt(rc, lp, 8, l);
  if (l == 255)
    gamma_encode(rc, &m.dlt_unary[(size_t)ti * 20], &m.dlt_bits[(size_t)ti * 20],
                 20, t.len - 255);
  if (t.is_digit) {
    size_t lc = t.len - 1 < 8 ? t.len - 1 : 7;
    for (uint32_t i = 0; i < t.len; ++i) {
      uint32_t* dp =
          &m.dig_c[(((size_t)ti * 8 + lc) * 8 + (i < 8 ? i : 7)) * 32];
      tree_encode_cnt(rc, dp, 4, t.p[i] - '0');
    }
  } else {
    uint16_t* cp = &m.chr_p[(size_t)ti * 512];
    for (uint32_t i = 0; i < t.len; ++i) tree_encode(rc, cp, 8, t.p[i]);
  }
}

void decode_literal(RangeDecoder& rc, Models& m, int ti, bool is_digit,
                    std::string& out) {
  uint32_t* lp = &m.len_c[(size_t)ti * 512];
  uint64_t len = tree_decode_cnt(rc, lp, 8);
  if (len == 255)
    len = 255 + gamma_decode(rc, &m.dlt_unary[(size_t)ti * 20],
                             &m.dlt_bits[(size_t)ti * 20], 20);
  if (is_digit) {
    // len==0 can only come from a corrupt stream; clamp, don't underflow
    size_t lc = len == 0 ? 0 : (len - 1 < 8 ? len - 1 : 7);
    for (uint64_t i = 0; i < len; ++i) {
      uint32_t* dp =
          &m.dig_c[(((size_t)ti * 8 + lc) * 8 + (i < 8 ? i : 7)) * 32];
      out.push_back((char)('0' + tree_decode_cnt(rc, dp, 4)));
    }
  } else {
    uint16_t* cp = &m.chr_p[(size_t)ti * 512];
    for (uint64_t i = 0; i < len; ++i) out.push_back((char)tree_decode(rc, cp, 8));
  }
}

// ---- template wire mode ----
// Typical id blocks are a single affine pattern ("@SRR.{i} {i} len=100").
// The adaptive coder's per-symbol determinism floor (~0.045 bits/sym)
// still costs ~5.6 KB per 1e6 such ids where the reference's count-based
// arithmetic models pay ~0.7 KB (src/id_compression token models,
// src/id_compression/include/sam_block.h:81-89). When every id in the
// block renders exactly from (literal tokens + digit tokens affine in
// the record index), ship the template itself: a few dozen bytes total.
// Wire: u32 0xFFFFFFFF sentinel (impossible id count — callers pass at
// most one file's ids per call), u32 count, u16 ntok, per token either
// literal bytes or (start, step, min-width).

constexpr uint32_t kTplMagic = 0xFFFFFFFFu;

struct TplTok {
  uint8_t kind;  // 0 literal, 1 affine digit run
  std::string lit;
  uint64_t start;
  int64_t step;
  uint8_t pad;  // minimum rendered width (zero padding); 0 = natural
};

// render v zero-padded to at least `pad` digits; returns length
inline int render_val(uint64_t v, int pad, char* buf) {
  char tmp[24];
  int bl = 0;
  do {
    tmp[bl++] = (char)('0' + v % 10);
    v /= 10;
  } while (v);
  int width = bl > pad ? bl : pad;
  int k = 0;
  for (int z = bl; z < width; ++z) buf[k++] = '0';
  for (int z = bl - 1; z >= 0; --z) buf[k++] = tmp[z];
  return k;
}

bool detect_template(const uint8_t* ids, const uint32_t* lens, uint32_t count,
                     std::vector<TplTok>& tpl) {
  if (count < 8) return false;
  std::vector<Token> t0, t1;
  tokenize(ids, lens[0], t0);
  tokenize(ids + lens[0], lens[1], t1);
  if (t0.size() != t1.size() || t0.empty() || t0.size() > 255) return false;
  tpl.clear();
  for (size_t i = 0; i < t0.size(); ++i) {
    const Token &a = t0[i], &b = t1[i];
    if (a.len == b.len && std::memcmp(a.p, b.p, a.len) == 0) {
      tpl.push_back({0, std::string((const char*)a.p, a.len), 0, 0, 0});
      continue;
    }
    if (!a.is_digit || !b.is_digit || !a.has_value || !b.has_value)
      return false;
    int64_t step = (int64_t)b.value - (int64_t)a.value;
    // keep step * r safely inside int64 for any u32 record index
    if (step > (int64_t)1 << 20 || step < -((int64_t)1 << 20)) return false;
    uint8_t pad = (a.len == b.len && a.len > 1 && a.p[0] == '0')
                      ? (uint8_t)a.len
                      : 0;
    tpl.push_back({1, std::string(), a.value, step, pad});
  }
  // exact verification: every id must render byte-identically
  char buf[32];
  const uint8_t* p = ids;
  for (uint32_t r = 0; r < count; ++r) {
    const uint8_t* q = p;
    uint32_t rem = lens[r];
    for (const TplTok& t : tpl) {
      if (t.kind == 0) {
        if (rem < t.lit.size() ||
            std::memcmp(q, t.lit.data(), t.lit.size()) != 0)
          return false;
        q += t.lit.size();
        rem -= (uint32_t)t.lit.size();
      } else {
        int64_t v = (int64_t)t.start + t.step * (int64_t)r;
        if (v < 0) return false;
        int l = render_val((uint64_t)v, t.pad, buf);
        if (rem < (uint32_t)l || std::memcmp(q, buf, (size_t)l) != 0)
          return false;
        q += l;
        rem -= (uint32_t)l;
      }
    }
    if (rem != 0) return false;
    p += lens[r];
  }
  return true;
}

inline void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((uint8_t)v);
  out.push_back((uint8_t)(v >> 8));
  out.push_back((uint8_t)(v >> 16));
  out.push_back((uint8_t)(v >> 24));
}

inline void put_u64(std::vector<uint8_t>& out, uint64_t v) {
  put_u32(out, (uint32_t)v);
  put_u32(out, (uint32_t)(v >> 32));
}

void encode_template(const std::vector<TplTok>& tpl, uint32_t count,
                     std::vector<uint8_t>& out) {
  put_u32(out, kTplMagic);
  put_u32(out, count);
  out.push_back((uint8_t)tpl.size());
  for (const TplTok& t : tpl) {
    out.push_back(t.kind);
    if (t.kind == 0) {
      put_u32(out, (uint32_t)t.lit.size());
      out.insert(out.end(), t.lit.begin(), t.lit.end());
    } else {
      put_u64(out, t.start);
      put_u64(out, (uint64_t)t.step);
      out.push_back(t.pad);
    }
  }
}

int64_t decode_template(const uint8_t* src, int64_t src_len,
                        std::vector<uint8_t>& out, std::vector<uint32_t>& lens) {
  int64_t pos = 4;  // past magic
  auto get_u32 = [&](uint32_t* v) -> bool {
    if (pos + 4 > src_len) return false;
    *v = (uint32_t)src[pos] | ((uint32_t)src[pos + 1] << 8) |
         ((uint32_t)src[pos + 2] << 16) | ((uint32_t)src[pos + 3] << 24);
    pos += 4;
    return true;
  };
  auto get_u64 = [&](uint64_t* v) -> bool {
    uint32_t lo, hi;
    if (!get_u32(&lo) || !get_u32(&hi)) return false;
    *v = (uint64_t)lo | ((uint64_t)hi << 32);
    return true;
  };
  uint32_t count;
  if (!get_u32(&count) || pos >= src_len) return -1;
  uint32_t ntok = src[pos++];
  std::vector<TplTok> tpl;
  uint64_t max_len = 0;
  for (uint32_t i = 0; i < ntok; ++i) {
    if (pos >= src_len) return -1;
    TplTok t;
    t.kind = src[pos++];
    if (t.kind == 0) {
      uint32_t l;
      if (!get_u32(&l) || pos + (int64_t)l > src_len || l > (1u << 20))
        return -1;
      t.lit.assign((const char*)src + pos, l);
      pos += l;
      max_len += l;
    } else if (t.kind == 1) {
      uint64_t st;
      if (!get_u64(&t.start) || !get_u64(&st) || pos >= src_len) return -1;
      t.step = (int64_t)st;
      if (t.step > (int64_t)1 << 20 || t.step < -((int64_t)1 << 20) ||
          t.start > (uint64_t)1 << 62)
        return -1;
      t.pad = src[pos++];
      // render_val writes max(ndigits, pad) bytes into a 32-byte buffer and a
      // u64 has <= 20 digits; the encoder never emits pad > 18, so any larger
      // value is a corrupt/hostile wire, not a valid archive.
      if (t.pad > 19) return -1;
      max_len += 24;
    } else {
      return -1;
    }
    tpl.push_back(std::move(t));
  }
  // size-claim guards: a hostile wire cannot make us allocate unbounded.
  // ntok == 0 would make max_len 0 and let any count through; counts near
  // 2^32 are far beyond any real block (~256k ids).
  if (ntok == 0 || count > (1u << 31)) return -1;
  if ((uint64_t)count * (max_len ? max_len : 1) > (1ull << 33)) return -1;
  out.clear();
  lens.clear();
  out.reserve((size_t)count * (size_t)max_len / 2);
  lens.reserve(count);
  char buf[32];
  for (uint32_t r = 0; r < count; ++r) {
    size_t before = out.size();
    for (const TplTok& t : tpl) {
      if (t.kind == 0) {
        out.insert(out.end(), t.lit.begin(), t.lit.end());
      } else {
        int64_t v = (int64_t)t.start + t.step * (int64_t)r;
        if (v < 0) return -1;
        int l = render_val((uint64_t)v, t.pad, buf);
        out.insert(out.end(), buf, buf + l);
      }
    }
    lens.push_back((uint32_t)(out.size() - before));
  }
  return (int64_t)out.size();
}

}  // namespace

// ids: concatenated bytes; lens: per-id lengths; count ids.
int64_t id_compress_block(const uint8_t* ids, const uint32_t* lens, uint32_t count,
                          std::vector<uint8_t>& out) {
  out.clear();
  {
    std::vector<TplTok> tpl;
    if (detect_template(ids, lens, count, tpl)) {
      encode_template(tpl, count, out);
      return (int64_t)out.size();
    }
  }
  // a fallback block whose count equals the template magic would produce a
  // header byte-identical to a template wire and mis-decode; real blocks are
  // ~256k ids so this is unreachable, but enforce the invariant anyway.
  if (count == kTplMagic) return -1;
  out.push_back((uint8_t)count);
  out.push_back((uint8_t)(count >> 8));
  out.push_back((uint8_t)(count >> 16));
  out.push_back((uint8_t)(count >> 24));
  Models m;
  RangeEncoder rc(&out);
  std::vector<Token> prev, cur;
  const uint8_t* p = ids;
  std::string prev_str;
  for (uint32_t r = 0; r < count; ++r) {
    uint32_t n = lens[r];
    tokenize(p, n, cur);
    for (size_t i = 0; i < cur.size(); ++i) {
      int ti = (int)(i < kMaxTokCtx ? i : kMaxTokCtx - 1);
      uint32_t* tp = &m.type_c[(size_t)ti * 8];
      const Token& t = cur[i];
      bool cmp = i < prev.size() && prev[i].is_digit == t.is_digit;
      uint64_t delta = 0;
      // intra-id duplicate: index among the current id's earlier digit
      // tokens, or -1 (chosen identically by the decoder)
      int dup_idx = -1;
      if (t.is_digit) {
        int di = 0;
        for (size_t j = 0; j < i; ++j) {
          if (!cur[j].is_digit) continue;
          if (cur[j].len == t.len &&
              std::memcmp(cur[j].p, t.p, t.len) == 0) {
            dup_idx = di;
            break;
          }
          ++di;
        }
      }
      if (cmp && prev[i].len == t.len &&
          std::memcmp(prev[i].p, t.p, t.len) == 0) {
        tree_encode_cnt(rc, tp, 3, T_MATCH);
      } else if (dup_idx >= 0) {
        tree_encode_cnt(rc, tp, 3, T_DUP);
        gamma_encode(rc, &m.dup_unary[(size_t)ti * 8],
                     &m.dup_bits[(size_t)ti * 8], 8, (uint64_t)dup_idx);
      } else if (cmp && t.is_digit && delta_representable(prev[i], t, &delta)) {
        tree_encode_cnt(rc, tp, 3, T_DELTA);
        gamma_encode(rc, &m.dlt_unary[(size_t)ti * 20],
                     &m.dlt_bits[(size_t)ti * 20], 20, delta);
      } else {
        tree_encode_cnt(rc, tp, 3, t.is_digit ? T_LIT_DIGIT : T_LIT_OTHER);
        encode_literal(rc, m, ti, t);
      }
    }
    int ti = (int)(cur.size() < kMaxTokCtx ? cur.size() : kMaxTokCtx - 1);
    tree_encode_cnt(rc, &m.type_c[(size_t)ti * 8], 3, T_END);
    prev_str.assign((const char*)p, n);
    tokenize((const uint8_t*)prev_str.data(), n, prev);
    p += n;
  }
  rc.flush();
  return (int64_t)out.size();
}

// returns total bytes written to `out`; fills lens_out (must hold count_in).
int64_t id_decompress_block(const uint8_t* src, int64_t src_len,
                            std::vector<uint8_t>& out, std::vector<uint32_t>& lens) {
  if (src_len < 4) return -1;
  uint32_t count = (uint32_t)src[0] | ((uint32_t)src[1] << 8) |
                   ((uint32_t)src[2] << 16) | ((uint32_t)src[3] << 24);
  if (count == kTplMagic) return decode_template(src, src_len, out, lens);
  Models m;
  RangeDecoder rc(src + 4, (size_t)(src_len - 4));
  out.clear();
  lens.clear();
  std::string prev_str, cur_str;
  std::vector<Token> prev;
  std::vector<std::pair<size_t, uint32_t>> digit_toks;  // (offset, len)
  for (uint32_t r = 0; r < count; ++r) {
    cur_str.clear();
    digit_toks.clear();
    size_t i = 0;
    for (;; ++i) {
      int ti = (int)(i < kMaxTokCtx ? i : kMaxTokCtx - 1);
      uint32_t tt = tree_decode_cnt(rc, &m.type_c[(size_t)ti * 8], 3);
      if (tt == T_END) break;
      size_t tok_off = cur_str.size();
      bool tok_digit = false;
      if (tt == T_MATCH) {
        if (i >= prev.size()) return -1;
        cur_str.append((const char*)prev[i].p, prev[i].len);
        tok_digit = prev[i].is_digit;
      } else if (tt == T_DUP) {
        uint64_t idx = gamma_decode(rc, &m.dup_unary[(size_t)ti * 8],
                                    &m.dup_bits[(size_t)ti * 8], 8);
        if (idx >= digit_toks.size()) return -1;
        auto [off, dl] = digit_toks[(size_t)idx];
        std::string dup = cur_str.substr(off, dl);  // self-append-safe
        cur_str += dup;
        tok_digit = true;
      } else if (tt == T_DELTA) {
        if (i >= prev.size() || !prev[i].has_value) return -1;
        uint64_t delta = gamma_decode(rc, &m.dlt_unary[(size_t)ti * 20],
                                      &m.dlt_bits[(size_t)ti * 20], 20);
        uint64_t v = prev[i].value + delta;
        char buf[24];
        int bl = 0;
        uint64_t tv = v;
        do {
          buf[bl++] = (char)('0' + tv % 10);
          tv /= 10;
        } while (tv);
        // zero-pad to previous width when the value fits in it
        int width = bl > (int)prev[i].len ? bl : (int)prev[i].len;
        for (int z = bl; z < width; ++z) cur_str.push_back('0');
        for (int z = bl - 1; z >= 0; --z) cur_str.push_back(buf[z]);
        tok_digit = true;
      } else if (tt == T_LIT_DIGIT || tt == T_LIT_OTHER) {
        decode_literal(rc, m, ti, tt == T_LIT_DIGIT, cur_str);
        tok_digit = tt == T_LIT_DIGIT;
      } else {
        return -1;
      }
      if (tok_digit)
        digit_toks.emplace_back(tok_off,
                                (uint32_t)(cur_str.size() - tok_off));
    }
    lens.push_back((uint32_t)cur_str.size());
    out.insert(out.end(), cur_str.begin(), cur_str.end());
    prev_str = cur_str;
    tokenize((const uint8_t*)prev_str.data(), (uint32_t)prev_str.size(), prev);
  }
  return (int64_t)out.size();
}

}  // namespace stpu
