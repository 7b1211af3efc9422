// Native FASTQ/FASTA parsing and 2-bit packing.
//
// Reference analog: read_fastq_block (src/util.cpp:31-54) and the 2-bit
// packers (src/util.cpp:269-320). The Python loops this replaces were the
// host-side bottleneck (~85k reads/s); this parses at memchr speed and
// packs with OpenMP.
//
// Layouts match io/packing.py: codes (n, maxlen) uint8 A0 C1 G2 T3 N4,
// zero-padded; packed (n, ceil(maxlen/16)) uint32, base i at bits 2*(i%16).
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Line {
  const uint8_t* p;
  int64_t len;   // excluding \n and \r
};

// next line from buf[pos..); returns false at EOF. pos advances past \n.
inline bool next_line(const uint8_t* buf, int64_t size, int64_t& pos, Line& l) {
  if (pos >= size) return false;
  const uint8_t* start = buf + pos;
  const uint8_t* nl =
      (const uint8_t*)memchr(start, '\n', (size_t)(size - pos));
  int64_t len = nl ? (int64_t)(nl - start) : size - pos;
  pos += len + (nl ? 1 : 0);
  if (len > 0 && start[len - 1] == '\r') --len;
  l.p = start;
  l.len = len;
  return true;
}

// base->code table via a C++11 magic static: thread-safe initialization
// even when several (Python) threads enter the parser concurrently
struct CodeTable {
  int8_t t[256];
  CodeTable() {
    for (int i = 0; i < 256; ++i) t[i] = -1;
    const char* b = "ACGTN";
    for (int i = 0; i < 5; ++i) {
      t[(uint8_t)b[i]] = (int8_t)i;
      t[(uint8_t)(b[i] + 32)] = (int8_t)i;
    }
  }
};

const int8_t* code_table() {
  static const CodeTable tbl;
  return tbl.t;
}

}  // namespace

extern "C" {

// Scan pass: count records and sizes. Returns 0 on success, -1 on a
// truncated FASTQ record. qual_mismatch counts records where the quality
// line length differs from the sequence length (caller decides to error,
// reference src/preprocess.cpp:200-202).
// checkpoint stride: record index/byte/id offsets every CKPT records so the
// parse pass can run record-parallel
static const int64_t kCkpt = 4096;

int64_t stpu_fastq_ckpt_stride() { return kCkpt; }

int64_t stpu_fastq_scan(const uint8_t* buf, int64_t size, int fasta,
                        int64_t* n_out, int64_t* maxlen_out,
                        int64_t* idbytes_out, int64_t* qual_mismatch,
                        int64_t* ckpt_byte, int64_t* ckpt_id) {
  int64_t pos = 0, n = 0, maxlen = 0, idbytes = 0, qmis = 0;
  Line id, seq, plus, qual;
  for (;;) {
    if (n % kCkpt == 0 && ckpt_byte) {
      ckpt_byte[n / kCkpt] = pos;
      ckpt_id[n / kCkpt] = idbytes;
    }
    if (!next_line(buf, size, pos, id)) break;
    if (!next_line(buf, size, pos, seq)) return -1;
    if (!fasta) {
      if (!next_line(buf, size, pos, plus)) return -1;
      if (!next_line(buf, size, pos, qual)) return -1;
      if (qual.len != seq.len) ++qmis;
    }
    ++n;
    if (seq.len > maxlen) maxlen = seq.len;
    idbytes += id.len;
  }
  *n_out = n;
  *maxlen_out = maxlen;
  *idbytes_out = idbytes;
  *qual_mismatch = qmis;
  return 0;
}

// Parse pass: fill preallocated arrays, record-parallel from the scan's
// checkpoints (this also spreads first-touch page faults of the big output
// arrays across cores — they dominate cold-start cost on this host).
// Returns 0, or -(record index + 1) on an invalid sequence character.
int64_t stpu_fastq_parse(const uint8_t* buf, int64_t size, int fasta,
                         int64_t n, int64_t maxlen, uint8_t* codes,
                         int32_t* lens, uint8_t* quals, int have_quals,
                         uint8_t* ids, uint32_t* idlens,
                         const int64_t* ckpt_byte, const int64_t* ckpt_id,
                         int num_threads) {
  const int8_t* g_code = code_table();
  int64_t nchunks = (n + kCkpt - 1) / kCkpt;
  if (nchunks == 0) return 0;
  // first failing record index (or INT64_MAX): min-reduced so the result
  // is deterministic and the write is race-free across OpenMP threads
  int64_t bad = INT64_MAX;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) reduction(min : bad) num_threads(num_threads > 0 ? num_threads : omp_get_max_threads())
#endif
  for (int64_t ch = 0; ch < nchunks; ++ch) {
    int64_t pos = ckpt_byte[ch];
    int64_t idw = ckpt_id[ch];
    int64_t r0 = ch * kCkpt;
    int64_t r1 = r0 + kCkpt < n ? r0 + kCkpt : n;
    Line id, seq, plus, qual;
    for (int64_t r = r0; r < r1; ++r) {
      if (!next_line(buf, size, pos, id) ||
          !next_line(buf, size, pos, seq)) {
        bad = bad < r + 1 ? bad : r + 1;
        break;
      }
      if (!fasta &&
          (!next_line(buf, size, pos, plus) ||
           !next_line(buf, size, pos, qual))) {
        bad = bad < r + 1 ? bad : r + 1;
        break;
      }
      if (seq.len > maxlen) {
        bad = bad < r + 1 ? bad : r + 1;
        break;
      }
      uint8_t* crow = codes + r * maxlen;
      bool ok = true;
      for (int64_t i = 0; i < seq.len; ++i) {
        int8_t c = g_code[seq.p[i]];
        if (c < 0) {
          ok = false;
          break;
        }
        crow[i] = (uint8_t)c;
      }
      if (!ok) {
        bad = bad < r + 1 ? bad : r + 1;
        break;
      }
      if (seq.len < maxlen)
        memset(crow + seq.len, 0, (size_t)(maxlen - seq.len));
      lens[r] = (int32_t)seq.len;
      if (!fasta && have_quals) {
        uint8_t* qrow = quals + r * maxlen;
        int64_t ql = qual.len < maxlen ? qual.len : maxlen;
        memcpy(qrow, qual.p, (size_t)ql);
        if (ql < maxlen) memset(qrow + ql, 0, (size_t)(maxlen - ql));
      }
      memcpy(ids + idw, id.p, (size_t)id.len);
      idlens[r] = (uint32_t)id.len;
      idw += id.len;
    }
  }
  return bad == INT64_MAX ? 0 : -bad;
}

// Parse pass writing packed 2-bit rows directly — the byte codes matrix
// never exists. N bases pack as A and are recorded as (record, pos) pairs
// in exc_pairs (capacity exc_cap pairs, chunk-reserved via an atomic
// cursor; order is nondeterministic across chunks — callers sort).
// Returns 0 ok (exc_count_out = pairs written), -(record+1) on a bad
// character; if exc_count_out > exc_cap the caller must retry with a
// larger buffer (pairs beyond the capacity were dropped).
int64_t stpu_fastq_parse_packed(const uint8_t* buf, int64_t size, int fasta,
                                int64_t n, int64_t maxlen, uint32_t* packed,
                                int32_t* lens, uint8_t* quals, int have_quals,
                                uint8_t* ids, uint32_t* idlens,
                                const int64_t* ckpt_byte,
                                const int64_t* ckpt_id, int32_t* exc_pairs,
                                int64_t exc_cap, int64_t* exc_count_out,
                                int num_threads) {
  const int8_t* g_code = code_table();
  int64_t W = (maxlen + 15) / 16;
  int64_t nchunks = (n + kCkpt - 1) / kCkpt;
  int64_t exc_cursor = 0;
  int64_t bad = INT64_MAX;
  if (nchunks) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) reduction(min : bad) num_threads(num_threads > 0 ? num_threads : omp_get_max_threads())
#endif
    for (int64_t ch = 0; ch < nchunks; ++ch) {
      int64_t pos = ckpt_byte[ch];
      int64_t idw = ckpt_id[ch];
      int64_t r0 = ch * kCkpt;
      int64_t r1 = r0 + kCkpt < n ? r0 + kCkpt : n;
      int32_t local_exc[2 * 1024];
      int64_t nloc = 0;
      Line id, seq, plus, qual;
      for (int64_t r = r0; r < r1; ++r) {
        if (!next_line(buf, size, pos, id) ||
            !next_line(buf, size, pos, seq)) {
          bad = bad < r + 1 ? bad : r + 1;
          break;
        }
        if (!fasta &&
            (!next_line(buf, size, pos, plus) ||
             !next_line(buf, size, pos, qual))) {
          bad = bad < r + 1 ? bad : r + 1;
          break;
        }
        if (seq.len > maxlen) {
          bad = bad < r + 1 ? bad : r + 1;
          break;
        }
        uint32_t* prow = packed + r * W;
        bool ok = true;
        uint32_t v = 0;
        int64_t w = 0;
        for (int64_t i = 0; i < seq.len; ++i) {
          int8_t c = g_code[seq.p[i]];
          if (c < 0) {
            ok = false;
            break;
          }
          if (c == 4) {
            // local N buffer flushes to the shared array when full so a
            // pathological all-N chunk still records every position
            if (nloc == 2 * 1024) {
              int64_t at;
#ifdef _OPENMP
#pragma omp atomic capture
              at = exc_cursor += nloc / 2;
#else
              at = exc_cursor += nloc / 2;
#endif
              at -= nloc / 2;
              for (int64_t k = 0; k < nloc && at + k / 2 < exc_cap; k += 2) {
                exc_pairs[(at + k / 2) * 2] = local_exc[k];
                exc_pairs[(at + k / 2) * 2 + 1] = local_exc[k + 1];
              }
              nloc = 0;
            }
            local_exc[nloc++] = (int32_t)r;
            local_exc[nloc++] = (int32_t)i;
            c = 0;              // N packs as A
          }
          v |= (uint32_t)(c & 3) << (2 * (i & 15));
          if ((i & 15) == 15) {
            prow[w++] = v;
            v = 0;
          }
        }
        if (!ok) {
          bad = bad < r + 1 ? bad : r + 1;
          break;
        }
        if (seq.len & 15) prow[w++] = v;
        for (; w < W; ++w) prow[w] = 0;
        lens[r] = (int32_t)seq.len;
        if (!fasta && have_quals) {
          uint8_t* qrow = quals + r * maxlen;
          int64_t ql = qual.len < maxlen ? qual.len : maxlen;
          memcpy(qrow, qual.p, (size_t)ql);
          if (ql < maxlen) memset(qrow + ql, 0, (size_t)(maxlen - ql));
        }
        memcpy(ids + idw, id.p, (size_t)id.len);
        idlens[r] = (uint32_t)id.len;
        idw += id.len;
      }
      if (nloc) {
        int64_t at;
#ifdef _OPENMP
#pragma omp atomic capture
        at = exc_cursor += nloc / 2;
#else
        at = exc_cursor += nloc / 2;
#endif
        at -= nloc / 2;
        for (int64_t k = 0; k < nloc && at + k / 2 < exc_cap; k += 2) {
          exc_pairs[(at + k / 2) * 2] = local_exc[k];
          exc_pairs[(at + k / 2) * 2 + 1] = local_exc[k + 1];
        }
      }
    }
  }
  *exc_count_out = exc_cursor;
  return bad == INT64_MAX ? 0 : -bad;
}

// codes (n, L) uint8 -> packed (n, W) uint32, W = ceil(L/16).
void stpu_pack_2bit(const uint8_t* codes, int64_t n, int64_t L,
                    uint32_t* packed, int num_threads) {
  int64_t W = (L + 15) / 16;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(num_threads > 0 ? num_threads : omp_get_max_threads())
#endif
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* row = codes + r * L;
    uint32_t* out = packed + r * W;
    for (int64_t w = 0; w < W; ++w) {
      uint32_t v = 0;
      int64_t base = w * 16;
      int64_t m = (L - base) < 16 ? (L - base) : 16;
      for (int64_t i = 0; i < m; ++i) v |= (uint32_t)(row[base + i] & 3) << (2 * i);
      out[w] = v;
    }
  }
}

// packed (n, W) uint32 -> codes (n, L) uint8 (0-3; zero padding beyond the
// packed words — callers overlay N positions separately). Inverse of
// stpu_pack_2bit for N-free rows.
void stpu_unpack_2bit(const uint32_t* packed, int64_t n, int64_t W, int64_t L,
                      uint8_t* codes, int num_threads) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(num_threads > 0 ? num_threads : omp_get_max_threads())
#endif
  for (int64_t r = 0; r < n; ++r) {
    const uint32_t* row = packed + r * W;
    uint8_t* out = codes + r * L;
    for (int64_t k = 0; k < L; ++k)
      out[k] = (uint8_t)((row[k >> 4] >> (2 * (k & 15))) & 3);
  }
}

// Format FASTQ/FASTA text from rows: chars (n, L) uint8 (already ASCII),
// lens, quals (n, L) or null, ids concatenated + idlens. Returns bytes
// written (caller sizes dst via stpu_fastq_format_bound).
int64_t stpu_fastq_format(const uint8_t* chars, const int32_t* lens,
                          const uint8_t* quals, const uint8_t* ids,
                          const uint32_t* idlens, int64_t n, int64_t L,
                          uint8_t* dst) {
  int64_t w = 0, idr = 0;
  for (int64_t r = 0; r < n; ++r) {
    memcpy(dst + w, ids + idr, idlens[r]);
    idr += idlens[r];
    w += idlens[r];
    dst[w++] = '\n';
    memcpy(dst + w, chars + r * L, (size_t)lens[r]);
    w += lens[r];
    dst[w++] = '\n';
    if (quals) {
      dst[w++] = '+';
      dst[w++] = '\n';
      memcpy(dst + w, quals + r * L, (size_t)lens[r]);
      w += lens[r];
      dst[w++] = '\n';
    }
  }
  return w;
}
}
