// Native consensus / noise / reconstruction kernels (encoder heart).
//
// Reference analog: buildcontig's majority vote (src/encoder.cpp:32-74),
// writecontig's per-read noise emission (src/encoder.cpp:76-109) and the
// decoder's seq.substr + noise-patch reconstruction
// (src/decompress.cpp:230-319). Redesign: the contigs are laid out in one
// concatenated coordinate space with globally nondecreasing read starts
// (encode/consensus.py builds that layout), so the consensus is an
// embarrassingly parallel span-owned counting pass and noise extraction is
// a flat parallel-for over reads — no per-contig serial walk.
//
// Each kernel is templated on a row accessor so it runs either over an
// unpacked (n, L) codes matrix (tests / small inputs) or directly over the
// pipeline's canonical packed 2-bit rows plus a sparse N-position overlay —
// the packed variants are what lets compression stream without ever
// materializing a whole-dataset codes matrix.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int threads_or_default(int num_threads) {
#ifdef _OPENMP
  return num_threads > 0 ? num_threads : omp_get_max_threads();
#else
  (void)num_threads;
  return 1;
#endif
}

// ---- row accessors ----

// unpacked (n, L) uint8 matrix, codes 0-3 = ACGT, 4 = N
struct MatrixRows {
  const uint8_t* codes;
  int64_t L;
  struct View {
    const uint8_t* row;
    inline uint8_t at(int32_t k) const { return row[k]; }
  };
  inline View row(int64_t rid) const { return View{codes + rid * L}; }
};

// packed 2-bit rows (n, W) uint32 (base i at bits 2*(i%16); N stored as A)
// plus a sparse overlay of N positions for the rows that contain them:
//   exc_rows: sorted rids with >=1 N; exc_off/(exc_pos): ragged positions
struct PackedRows {
  const uint32_t* packed;
  int64_t W;
  const int32_t* exc_rows;
  const int64_t* exc_off;
  const int32_t* exc_pos;
  int64_t n_exc;
  struct View {
    const uint32_t* row;
    const int32_t* np0;
    const int32_t* np1;
    inline uint8_t at(int32_t k) const {
      for (const int32_t* p = np0; p < np1; ++p)
        if (*p == k) return 4;
      return (uint8_t)((row[k >> 4] >> (2 * (k & 15))) & 3);
    }
  };
  inline View row(int64_t rid) const {
    View v{packed + rid * W, nullptr, nullptr};
    if (n_exc) {
      const int32_t* e =
          std::lower_bound(exc_rows, exc_rows + n_exc, (int32_t)rid);
      if (e != exc_rows + n_exc && *e == (int32_t)rid) {
        int64_t i = e - exc_rows;
        v.np0 = exc_pos + exc_off[i];
        v.np1 = exc_pos + exc_off[i + 1];
      }
    }
    return v;
  }
};

// oriented base k of a row view (complement of N = N)
template <class V>
inline uint8_t oriented_base(const V& v, int32_t len, uint8_t rc, int32_t k) {
  if (!rc) return v.at(k);
  uint8_t c = v.at(len - 1 - k);
  return c < 4 ? (uint8_t)(3 - c) : c;
}

// ---- kernel bodies ----

template <class Rows>
void consensus_impl(const Rows& rows, const int32_t* lengths,
                    const int32_t* rids, const int64_t* gpos,
                    const uint8_t* rc, int64_t M, int64_t seq_len,
                    uint8_t* out, int num_threads) {
  if (seq_len <= 0) return;
  int T = threads_or_default(num_threads);
  if (M < 4096) T = 1;
  // maximum read length bounds how far back a read can reach into a
  // span; the layout guarantees read starts are nondecreasing
  int64_t maxl = 0;
  for (int64_t j = 0; j < M; ++j)
    if (lengths[rids[j]] > maxl) maxl = lengths[rids[j]];
#ifdef _OPENMP
#pragma omp parallel num_threads(T)
#endif
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
    int nt = omp_get_num_threads();
#else
    int t = 0, nt = 1;
#endif
    int64_t lo = seq_len * t / nt;
    int64_t hi = seq_len * (t + 1) / nt;
    if (hi > lo) {
      // first read that can reach into [lo, hi): gpos > lo - maxl
      int64_t j0 = std::upper_bound(gpos, gpos + M, lo - maxl) - gpos;
      // first read starting at or past hi
      int64_t j1 = std::lower_bound(gpos, gpos + M, hi) - gpos;
      std::vector<uint32_t> counts((size_t)(hi - lo) * 4, 0);
      for (int64_t j = j0; j < j1; ++j) {
        auto v = rows.row(rids[j]);
        int32_t len = lengths[rids[j]];
        int64_t g = gpos[j];
        int32_t k0 = g < lo ? (int32_t)(lo - g) : 0;
        int32_t k1 = g + len > hi ? (int32_t)(hi - g) : len;
        uint8_t r = rc[j];
        uint32_t* cbase = counts.data() + (size_t)(g - lo) * 4;
        if (!r) {
          for (int32_t k = k0; k < k1; ++k) {
            uint8_t c = v.at(k);
            if (c < 4) cbase[(size_t)k * 4 + c]++;
          }
        } else {
          for (int32_t k = k0; k < k1; ++k) {
            uint8_t c = v.at(len - 1 - k);
            if (c < 4) cbase[(size_t)k * 4 + (3 - c)]++;
          }
        }
      }
      for (int64_t p = 0; p < hi - lo; ++p) {
        const uint32_t* c = counts.data() + (size_t)p * 4;
        uint8_t best = 0;
        uint32_t bc = c[0];
        for (uint8_t b = 1; b < 4; ++b)
          if (c[b] > bc) { bc = c[b]; best = b; }
        out[lo + p] = best;  // all-zero -> 0 (A), matching np.argmax
      }
    }
  }
}

// consensus base at window position k, clipped to [0, seq_len-1] like the
// numpy path (second-chance placements may touch the boundary)
inline uint8_t cons_at(const uint8_t* consensus, int64_t seq_len, int64_t g,
                       int32_t k) {
  int64_t p = g + k;
  return consensus[p < 0 ? 0 : (p >= seq_len ? seq_len - 1 : p)];
}

// Pass 1: per-read mismatch count vs the consensus window.
template <class Rows>
void noise_count_impl(const Rows& rows, const int32_t* lengths,
                      const int32_t* rids, const int64_t* gpos,
                      const uint8_t* rc, int64_t M, const uint8_t* consensus,
                      int64_t seq_len, int32_t* out_nn, int num_threads) {
  int T = threads_or_default(num_threads);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(T)
#endif
  for (int64_t j = 0; j < M; ++j) {
    auto v = rows.row(rids[j]);
    int32_t len = lengths[rids[j]];
    int64_t g = gpos[j];
    int32_t nn = 0;
    uint8_t r = rc[j];
    if (g >= 0 && g + len <= seq_len) {
      const uint8_t* cons = consensus + g;
      for (int32_t k = 0; k < len; ++k)
        nn += oriented_base(v, len, r, k) != cons[k];
    } else {
      for (int32_t k = 0; k < len; ++k)
        nn += oriented_base(v, len, r, k) != cons_at(consensus, seq_len, g, k);
    }
    out_nn[j] = nn;
  }
}

// Pass 2: fill noisepos (position within the oriented read, ascending) and
// noisechar (rank of the read base among bases != consensus base; N -> 3 —
// reference enc_noise substitution table, src/encoder.h:517-537).
template <class Rows>
void noise_fill_impl(const Rows& rows, const int32_t* lengths,
                     const int32_t* rids, const int64_t* gpos,
                     const uint8_t* rc, int64_t M, const uint8_t* consensus,
                     int64_t seq_len, const int64_t* noise_off,
                     int32_t* out_npos, uint8_t* out_nchar, int num_threads) {
  int T = threads_or_default(num_threads);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(T)
#endif
  for (int64_t j = 0; j < M; ++j) {
    auto v = rows.row(rids[j]);
    int32_t len = lengths[rids[j]];
    int64_t g = gpos[j];
    int64_t o = noise_off[j];
    uint8_t r = rc[j];
    for (int32_t k = 0; k < len; ++k) {
      uint8_t rd = oriented_base(v, len, r, k);
      uint8_t rf = cons_at(consensus, seq_len, g, k);
      if (rd != rf) {
        out_npos[o] = k;
        out_nchar[o] = rd == 4 ? 3 : (uint8_t)(rd - (rd > rf));
        ++o;
      }
    }
  }
}

}  // namespace

extern "C" {

// Majority-vote consensus over the concatenated contig space.
//   codes:  (nrows, L) uint8 code rows, indexed by rids
//   rids/gpos/rc: layout arrays (M,), gpos nondecreasing
//   out:    (seq_len,) uint8 consensus codes
// Each thread owns a disjoint output span; reads overlapping the span are
// found by binary search (read starts are sorted, window width <= maxlen).
void stpu_consensus(const uint8_t* codes, int64_t L, const int32_t* lengths,
                    const int32_t* rids, const int64_t* gpos,
                    const uint8_t* rc, int64_t M, int64_t seq_len,
                    uint8_t* out, int num_threads) {
  consensus_impl(MatrixRows{codes, L}, lengths, rids, gpos, rc, M, seq_len,
                 out, num_threads);
}

void stpu_noise_count(const uint8_t* codes, int64_t L, const int32_t* lengths,
                      const int32_t* rids, const int64_t* gpos,
                      const uint8_t* rc, int64_t M, const uint8_t* consensus,
                      int64_t seq_len, int32_t* out_nn, int num_threads) {
  noise_count_impl(MatrixRows{codes, L}, lengths, rids, gpos, rc, M,
                   consensus, seq_len, out_nn, num_threads);
}

void stpu_noise_fill(const uint8_t* codes, int64_t L, const int32_t* lengths,
                     const int32_t* rids, const int64_t* gpos,
                     const uint8_t* rc, int64_t M, const uint8_t* consensus,
                     int64_t seq_len, const int64_t* noise_off,
                     int32_t* out_npos, uint8_t* out_nchar, int num_threads) {
  noise_fill_impl(MatrixRows{codes, L}, lengths, rids, gpos, rc, M, consensus,
                  seq_len, noise_off, out_npos, out_nchar, num_threads);
}

// Packed-row variants: codes come from (nrows, W) uint32 packed 2-bit rows
// (N stored as A) with the N positions supplied as a sparse overlay
// (exc_rows sorted, exc_off/(exc_pos) ragged per exception row).
void stpu_consensus_p(const uint32_t* packed, int64_t W,
                      const int32_t* lengths, const int32_t* rids,
                      const int64_t* gpos, const uint8_t* rc, int64_t M,
                      int64_t seq_len, uint8_t* out, int num_threads) {
  consensus_impl(PackedRows{packed, W, nullptr, nullptr, nullptr, 0}, lengths,
                 rids, gpos, rc, M, seq_len, out, num_threads);
}

void stpu_noise_count_p(const uint32_t* packed, int64_t W,
                        const int32_t* lengths, const int32_t* exc_rows,
                        const int64_t* exc_off, const int32_t* exc_pos,
                        int64_t n_exc, const int32_t* rids,
                        const int64_t* gpos, const uint8_t* rc, int64_t M,
                        const uint8_t* consensus, int64_t seq_len,
                        int32_t* out_nn, int num_threads) {
  noise_count_impl(PackedRows{packed, W, exc_rows, exc_off, exc_pos, n_exc},
                   lengths, rids, gpos, rc, M, consensus, seq_len, out_nn,
                   num_threads);
}

void stpu_noise_fill_p(const uint32_t* packed, int64_t W,
                       const int32_t* lengths, const int32_t* exc_rows,
                       const int64_t* exc_off, const int32_t* exc_pos,
                       int64_t n_exc, const int32_t* rids,
                       const int64_t* gpos, const uint8_t* rc, int64_t M,
                       const uint8_t* consensus, int64_t seq_len,
                       const int64_t* noise_off, int32_t* out_npos,
                       uint8_t* out_nchar, int num_threads) {
  noise_fill_impl(PackedRows{packed, W, exc_rows, exc_off, exc_pos, n_exc},
                  lengths, rids, gpos, rc, M, consensus, seq_len, noise_off,
                  out_npos, out_nchar, num_threads);
}

// Decoder: rebuild (M, L) oriented code rows from consensus + noise, then
// un-orient RC rows. Inverse of the two kernels above.
//   npos: absolute position within the oriented read (delta already undone)
void stpu_reconstruct(const uint8_t* consensus, int64_t seq_len,
                      const int64_t* gpos, const int32_t* lengths,
                      const uint8_t* rc, const int32_t* nn,
                      const int64_t* noise_off, const int32_t* npos,
                      const uint8_t* nchar, int64_t M, int64_t L,
                      uint8_t* out, int num_threads) {
  int T = threads_or_default(num_threads);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(T)
#endif
  for (int64_t j = 0; j < M; ++j) {
    uint8_t* row = out + j * L;
    int32_t len = lengths[j];
    int64_t g = gpos[j];
    // clamp like the numpy path: out-of-range reads as position 0 (the
    // caller treats impossible layouts as corrupt archives downstream)
    for (int32_t k = 0; k < len; ++k) {
      int64_t p = g + k;
      row[k] = consensus[p < 0 ? 0 : (p >= seq_len ? seq_len - 1 : p)];
    }
    for (int32_t k = len; k < L; ++k) row[k] = 0;
    int64_t o = noise_off[j];
    for (int32_t i = 0; i < nn[j]; ++i) {
      int32_t p = npos[o + i];
      if (p < 0 || p >= len) continue;  // corrupt stream: ignore, caller
                                        // validates round-trip elsewhere
      uint8_t rel = nchar[o + i];
      uint8_t rf = row[p];
      row[p] = rel == 3 ? 4 : (uint8_t)(rel + (rel >= rf));
    }
    if (rc[j]) {
      for (int32_t a = 0, b = len - 1; a < b; ++a, --b) {
        uint8_t x = row[a], y = row[b];
        row[a] = y < 4 ? (uint8_t)(3 - y) : y;
        row[b] = x < 4 ? (uint8_t)(3 - x) : x;
      }
      if (len & 1) {
        uint8_t x = row[len / 2];
        row[len / 2] = x < 4 ? (uint8_t)(3 - x) : x;
      }
    }
  }
}

}  // extern "C"
