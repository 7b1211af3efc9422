// Adaptive binary range coder (carry-counting, 32-bit range, 12-bit probs).
//
// Reference analog: the reference embeds two arithmetic coders — libbsc's
// QLFC binary coder (src/libbsc/libbsc/coder/qlfc/) and the id_compression
// 32-bit arithmetic coder (src/id_compression/src/Arithmetic_stream.cpp).
// This is a from-scratch implementation of the standard carry-less binary
// range coder (as used across LZMA-family codecs), shared by every native
// codec in spring-tpu.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace stpu {

// Probability precision trades an adaptation FLOOR against a rare-symbol
// CEILING: updates stall when (max-p) >> kAdaptShift rounds to 0, so a
// fully-predicted bit costs -log2(1 - 2^kAdaptShift / 2^kProbBits), while
// the minimum reachable probability (worst-case surprise cost) also
// scales with 2^-kProbBits. 12 bits suits noisy streams (quality: 15-bit
// probs cost +1.2% — rare symbols get pushed too cheap); 15 bits suits
// near-deterministic streams (sequential read ids: the 12-bit floor of
// 0.011 bits/bit x 27 coded bits was 0.30 bits/id; 15-bit is 6.7x
// smaller). Per-codec choice via the templated *_pb entry points.
static constexpr int kProbBits = 12;
static constexpr uint16_t kProbInit = 1u << (kProbBits - 1);
static constexpr int kProbBitsHi = 15;
static constexpr uint16_t kProbInitHi = 1u << (kProbBitsHi - 1);
static constexpr int kAdaptShift = 5;
static constexpr uint32_t kTopValue = 1u << 24;

struct RangeEncoder {
  std::vector<uint8_t>* out;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  uint64_t cache_size = 1;

  explicit RangeEncoder(std::vector<uint8_t>* o) : out(o) {}

  inline void shift_low() {
    if ((uint32_t)(low >> 32) != 0 || (uint32_t)low < 0xFF000000u) {
      uint8_t carry = (uint8_t)(low >> 32);
      while (cache_size != 0) {
        out->push_back((uint8_t)(cache + carry));
        cache = 0xFF;
        --cache_size;
      }
      cache = (uint8_t)(low >> 24);
      cache_size = 0;
    }
    ++cache_size;
    low = (low << 8) & 0xFFFFFFFFull;
  }

  template <int PB>
  inline void encode_bit_pb(uint16_t* prob, int bit) {
    uint32_t bound = (range >> PB) * (*prob);
    if (!bit) {
      range = bound;
      *prob += (uint16_t)(((1u << PB) - *prob) >> kAdaptShift);
    } else {
      low += bound;
      range -= bound;
      *prob -= (uint16_t)(*prob >> kAdaptShift);
    }
    while (range < kTopValue) {
      range <<= 8;
      shift_low();
    }
  }

  inline void encode_bit(uint16_t* prob, int bit) {
    encode_bit_pb<kProbBits>(prob, bit);
  }

  // encode `nbits` raw bits of v, MSB first, at probability 1/2 (no model)
  inline void encode_direct(uint32_t v, int nbits) {
    for (int i = nbits - 1; i >= 0; --i) {
      range >>= 1;
      uint32_t b = (v >> i) & 1;
      low += b ? range : 0;
      while (range < kTopValue) {
        range <<= 8;
        shift_low();
      }
    }
  }

  inline void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct RangeDecoder {
  const uint8_t* in;
  size_t pos = 0, size = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  RangeDecoder(const uint8_t* p, size_t n) : in(p), size(n) {
    ++pos;  // first byte emitted by the encoder's cache priming is 0
    for (int i = 0; i < 4; ++i) code = (code << 8) | next_byte();
  }

  inline uint8_t next_byte() { return pos < size ? in[pos++] : 0; }

  template <int PB>
  inline int decode_bit_pb(uint16_t* prob) {
    uint32_t bound = (range >> PB) * (*prob);
    int bit;
    if (code < bound) {
      range = bound;
      *prob += (uint16_t)(((1u << PB) - *prob) >> kAdaptShift);
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      *prob -= (uint16_t)(*prob >> kAdaptShift);
      bit = 1;
    }
    while (range < kTopValue) {
      range <<= 8;
      code = (code << 8) | next_byte();
    }
    return bit;
  }

  inline int decode_bit(uint16_t* prob) {
    return decode_bit_pb<kProbBits>(prob);
  }

  inline uint32_t decode_direct(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i) {
      range >>= 1;
      uint32_t b = (code >= range);
      if (b) code -= range;
      v = (v << 1) | b;
      while (range < kTopValue) {
        range <<= 8;
        code = (code << 8) | next_byte();
      }
    }
    return v;
  }
};

// Adaptive bit-tree coder over an n-bit alphabet (MSB-first traversal).
template <int NBits>
struct BitTree {
  uint16_t probs[1 << NBits];
  BitTree() { reset(); }
  void reset() {
    for (auto& p : probs) p = kProbInit;
  }
  inline void encode(RangeEncoder& rc, uint32_t sym) {
    uint32_t node = 1;
    for (int i = NBits - 1; i >= 0; --i) {
      int bit = (sym >> i) & 1;
      rc.encode_bit(&probs[node], bit);
      node = (node << 1) | bit;
    }
  }
  inline uint32_t decode(RangeDecoder& rc) {
    uint32_t node = 1;
    for (int i = 0; i < NBits; ++i) node = (node << 1) | rc.decode_bit(&probs[node]);
    return node - (1u << NBits);
  }
};

}  // namespace stpu
