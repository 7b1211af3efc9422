// SA-IS suffix array construction (Nong, Zhang & Chan, 2009) — from scratch.
//
// Reference analog: the reference vendors divsufsort inside libbsc
// (src/libbsc/libbsc/bwt/divsufsort/divsufsort.c) to drive its BWT stage.
// We implement the linear-time SA-IS algorithm instead: induced sorting of
// LMS substrings with recursion on the reduced problem.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace stpu {

namespace sais_detail {

inline bool is_lms(const std::vector<uint8_t>& t, int32_t i) {
  return i > 0 && t[i] && !t[i - 1];
}

template <typename CharT>
void get_buckets(const CharT* s, int32_t n, int32_t K, std::vector<int32_t>& bkt,
                 bool end) {
  std::fill(bkt.begin(), bkt.end(), 0);
  for (int32_t i = 0; i < n; ++i) ++bkt[s[i]];
  int32_t sum = 0;
  for (int32_t c = 0; c < K; ++c) {
    sum += bkt[c];
    bkt[c] = end ? sum : sum - bkt[c];
  }
}

template <typename CharT>
void induce_sa_l(const CharT* s, int32_t* sa, int32_t n, int32_t K,
                 const std::vector<uint8_t>& t, std::vector<int32_t>& bkt) {
  get_buckets(s, n, K, bkt, false);
  for (int32_t i = 0; i < n; ++i) {
    int32_t j = sa[i] - 1;
    if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
  }
}

template <typename CharT>
void induce_sa_s(const CharT* s, int32_t* sa, int32_t n, int32_t K,
                 const std::vector<uint8_t>& t, std::vector<int32_t>& bkt) {
  get_buckets(s, n, K, bkt, true);
  for (int32_t i = n - 1; i >= 0; --i) {
    int32_t j = sa[i] - 1;
    if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
  }
}

// Core SA-IS. s[n-1] must be a unique sentinel, strictly smaller than all
// other symbols. Symbols in [0, K). sa has room for n entries.
template <typename CharT>
void sais_main(const CharT* s, int32_t* sa, int32_t n, int32_t K) {
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<uint8_t> t(n);
  t[n - 1] = true;
  if (n >= 2) t[n - 2] = false;
  for (int32_t i = n - 3; i >= 0; --i)
    t[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1]);

  std::vector<int32_t> bkt(K);
  // step 1: place LMS suffixes at bucket ends, induce-sort LMS substrings
  get_buckets(s, n, K, bkt, true);
  std::fill(sa, sa + n, -1);
  for (int32_t i = 1; i < n; ++i)
    if (is_lms(t, i)) sa[--bkt[s[i]]] = i;
  induce_sa_l(s, sa, n, K, t, bkt);
  induce_sa_s(s, sa, n, K, t, bkt);

  // compact sorted LMS substrings into the front of sa
  int32_t n1 = 0;
  for (int32_t i = 0; i < n; ++i)
    if (is_lms(t, sa[i])) sa[n1++] = sa[i];

  // name LMS substrings
  std::fill(sa + n1, sa + n, -1);
  int32_t name = 0, prev = -1;
  for (int32_t i = 0; i < n1; ++i) {
    int32_t pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int32_t d = 0;; ++d) {
        if (pos + d >= n || prev + d >= n || s[pos + d] != s[prev + d] ||
            t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(t, pos + d) || is_lms(t, prev + d))) {
          diff = !(is_lms(t, pos + d) && is_lms(t, prev + d));
          break;
        }
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  for (int32_t i = n - 1, j = n - 1; i >= n1; --i)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // step 2: solve the reduced problem
  int32_t* sa1 = sa;
  int32_t* s1 = sa + n - n1;
  if (name < n1) {
    sais_main<int32_t>(s1, sa1, n1, name);
  } else {
    for (int32_t i = 0; i < n1; ++i) sa1[s1[i]] = i;
  }

  // step 3: induce the final SA from the sorted LMS suffixes
  std::vector<int32_t> lms(n1);
  for (int32_t i = 1, j = 0; i < n; ++i)
    if (is_lms(t, i)) lms[j++] = i;
  for (int32_t i = 0; i < n1; ++i) sa1[i] = lms[sa1[i]];
  std::fill(sa + n1, sa + n, -1);
  get_buckets(s, n, K, bkt, true);
  for (int32_t i = n1 - 1; i >= 0; --i) {
    int32_t j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
  }
  induce_sa_l(s, sa, n, K, t, bkt);
  induce_sa_s(s, sa, n, K, t, bkt);
}

}  // namespace sais_detail

// Suffix array of `data` (no sentinel required in the input; an implicit
// one is appended). Fills sa with n+1 entries; sa[0] == n (the sentinel).
inline void suffix_array_u8(const uint8_t* data, int32_t n, int32_t* sa) {
  // shift alphabet by +1 so 0 is the unique sentinel; uint16 keeps the
  // top-level passes cache-friendly (int32 widening halved throughput)
  std::vector<uint16_t> s(n + 1);
  for (int32_t i = 0; i < n; ++i) s[i] = (uint16_t)(data[i] + 1);
  s[n] = 0;
  sais_detail::sais_main<uint16_t>(s.data(), sa, n + 1, 257);
}

}  // namespace stpu
