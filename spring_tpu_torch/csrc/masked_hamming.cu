// Masked Hamming verify over 2-bit packed DNA words, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spring_tpu/ops/pallas_kernels.py::
// masked_hamming (body _ham_kernel, range mask _prefix_word) and, around
// it, the verify stage of the reorder round that the JAX package leaves to
// one XLA fusion (spring_tpu/reorder/engine.py, "verify: ONE (B, M) row
// gather + masked popcounts").
//
// The inner loop, shared by every entry (ham_word): XOR a frame word with
// a row word, fold each 2-bit lane onto its low bit, AND with the mask of
// the bases in [lo, hi) that fall into this word, popcount.
//
// Entries:
//   stpu_verify_rows     the round's fused fetch-and-verify: for walker b
//                        and slot m it clamps the candidate id, reads the
//                        candidate's row (W data words and the length
//                        word) straight from the (Np, W+1) table, tests
//                        its bit in the claimed bitmap, derives lo, hi and
//                        t from the slot's frame index, the walker's shift
//                        base and consensus length, takes the masked
//                        Hamming of frame[b, k_frame] against the row, and
//                        writes ok, t, clen, ham. Nothing it gathers is
//                        written back to device memory.
//   stpu_masked_hamming  the Pallas kernel's own function over strided
//                        frames and rows (word-major (W, B, K), or the
//                        row-major layout), one thread per output.
//   *_timed              the same launches, `reps` of them captured into a
//                        CUDA graph and replayed between two events: the
//                        device's time of one launch with no host call
//                        between launches (see timed()).
//
// What bounds the fused kernel on this card: bytes. Per output a random
// 32-byte row (one sector), 13 bytes of slot inputs, one bitmap word, 13
// bytes out; per walker the frames its slots name (the kernel stages all
// 2*SC of a walker, contiguous and coalesced, though its M slots name at
// most M of them). About 120 integer operations an
// output are twenty times cheaper than the bytes. At the round's size
// (65,536 outputs) the whole grid is resident at once, so the time is the
// launch plus one chain of dependent memory latencies: candidate id ->
// row. The design keeps that chain as short as the data allows:
//   - a block owns whole walkers. Their frames are copied once into
//     shared memory with cp.async, which costs no register and is in
//     flight while the threads already fetch candidate ids and rows; the
//     M slots of a walker reuse them from there. Its ref_len and
//     shift_base reach its slots as one broadcast load a warp.
//   - the row gather is the only scattered read: one thread per output;
//     the 32-byte row of W = 7 is two 128-bit non-coherent loads and the
//     W loop is unrolled; any other W takes scalar loads of the same row.
//     (Eight lanes per output, one word a lane, was measured too and is
//     slower on this card: every row is one sector either way, and it
//     needs eight times the threads. PERF.md has the times.)
//   - every input goes through the read-only path (__ldg); the claimed
//     bitmap is read, never written, here.
// wgmma and TMA have no use here: no matrix product, and the rows are a
// random gather of single sectors.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see spring_tpu_torch/ops/_build.py).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// Mask of the first nb 2-bit lanes of a word, nb clipped to 0..16; never
// shifts by 32.
__device__ __forceinline__ uint32_t prefix_word(int nb) {
  nb = min(nb, 16);
  return nb > 0 ? (0xFFFFFFFFu >> (32 - 2 * nb)) : 0u;
}

// Mismatching bases of word w (bases 16w .. 16w+15) inside [lo, hi).
__device__ __forceinline__ int ham_word(uint32_t f, uint32_t r, int lo,
                                        int hi, int w) {
  const uint32_t d = f ^ r;
  const uint32_t m = (d | (d >> 1)) & 0x55555555u;
  return __popc(m & prefix_word(hi - 16 * w) & ~prefix_word(lo - 16 * w));
}

// ---------------------------------------------------------------------
// The Pallas kernel's function: out[i] over strided frames and rows.
// WT > 0 fixes the word count at compile time (the loop unrolls and the
// loads go out together); WT == 0 takes it from W.
template <int WT>
__global__ void masked_hamming_kernel(const uint32_t* __restrict__ frames,
                                      const uint32_t* __restrict__ rows,
                                      const int32_t* __restrict__ lo,
                                      const int32_t* __restrict__ hi,
                                      int32_t* __restrict__ out, int64_t n,
                                      int W, int64_t f_word, int64_t f_row,
                                      int64_t r_word, int64_t r_row) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nw = WT > 0 ? WT : W;
  const int l = __ldg(lo + i);
  const int h = __ldg(hi + i);
  const uint32_t* f = frames + i * f_row;
  const uint32_t* r = rows + i * r_row;
  int acc = 0;
#pragma unroll
  for (int w = 0; w < nw; ++w)
    acc += ham_word(__ldg(f + w * f_word), __ldg(r + w * r_word), l, h, w);
  out[i] = acc;
}

// ---------------------------------------------------------------------
// The fused verify.

struct VerifyArgs {
  const uint32_t* rows_tab;   // (Np, W + 1)
  const int32_t* cand;        // (B, M)
  const uint8_t* valid;       // (B, M) bool
  const uint32_t* claimed;    // bitmap, >= Np bits
  const uint32_t* frames;     // (B, F, W), F = 2 * SC
  const int32_t* k_frame;     // (B, M), in [0, F)
  const int32_t* shift_base;  // (B,)
  const int32_t* ref_len;     // (B,)
  uint8_t* ok;                // (B, M) bool
  int32_t* t;                 // (B, M)
  int32_t* clen;              // (B, M)
  int32_t* ham;               // (B, M)
  int B, M, W, F, Np, thresh;
  int wpb;                    // walkers per block
};

// One slot's scalars, everything but the Hamming sum.
struct Slot {
  int safe, kf, lo, hi, t, clen;
  bool pre_ok;  // valid & ~claimed
};

// Start the copy of this block's frames into shared memory.
__device__ __forceinline__ void stage_frames(const VerifyArgs& a, int b0,
                                             int nb, uint32_t* sfr) {
  const int fw = a.F * a.W;
  const uint32_t* src = a.frames + (int64_t)b0 * fw;
  const int words = nb * fw;
  if ((fw & 3) == 0 && (reinterpret_cast<uintptr_t>(a.frames) & 15) == 0) {
    for (int i = threadIdx.x * 4; i < words; i += blockDim.x * 4)
      __pipeline_memcpy_async(sfr + i, src + i, 16);
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x)
      __pipeline_memcpy_async(sfr + i, src + i, 4);
  }
  __pipeline_commit();
}

// lo, hi, t of a slot from its frame index and its walker's scalars.
__device__ __forceinline__ void slot_range(Slot& s, int kf_raw, int sb,
                                           int rl) {
  const int sh = sb + (kf_raw >> 1);
  if ((kf_raw & 1) == 0) {
    s.lo = 0;
    s.hi = min(rl - sh, s.clen);
    s.t = sh;
  } else {
    s.lo = sh;
    s.hi = min(rl + sh, s.clen);
    s.t = rl + sh - s.clen;
  }
}

__device__ __forceinline__ void store_slot(const VerifyArgs& a, int64_t i,
                                           const Slot& s, int ham) {
  a.ham[i] = ham;
  a.t[i] = s.t;
  a.clen[i] = s.clen;
  a.ok[i] = (uint8_t)(s.pre_ok && ham <= a.thresh && s.t >= 0 &&
                      s.hi > s.lo);
}

// One thread per output; a block owns a.wpb whole walkers and stages
// their frames. W7: the table's rows are 8 words on a 16-byte aligned
// base, W == 7.
template <bool W7>
__global__ void verify_rows_kernel(const VerifyArgs a) {
  extern __shared__ __align__(16) uint32_t sfr[];
  const int b0 = blockIdx.x * a.wpb;
  const int nb = min(a.wpb, a.B - b0);
  const int nout = nb * a.M;
  const int fw = a.F * a.W;
  const int W1 = a.W + 1;
  stage_frames(a, b0, nb, sfr);
  for (int base = 0; base < nout; base += blockDim.x) {
    const int o = base + threadIdx.x;
    const bool act = o < nout;
    const int wl = act ? o / a.M : 0;           // walker within the block
    const int64_t i = (int64_t)b0 * a.M + (act ? o : 0);
    Slot s;
    const int c = __ldg(a.cand + i);
    const int kf_raw = __ldg(a.k_frame + i);
    const bool valid = __ldg(a.valid + i) != 0;
    s.safe = min(max(c, 0), a.Np - 1);
    s.kf = min(max(kf_raw, 0), a.F - 1);
    const uint32_t* row = a.rows_tab + (int64_t)s.safe * W1;
    uint4 r0, r1;
    if (W7) {
      r0 = __ldg(reinterpret_cast<const uint4*>(row));
      r1 = __ldg(reinterpret_cast<const uint4*>(row) + 1);
    }
    const uint32_t lenw = W7 ? r1.w : __ldg(row + a.W);
    const uint32_t cw = __ldg(a.claimed + (s.safe >> 5));
    const int sb = __ldg(a.shift_base + b0 + wl);
    const int rl = __ldg(a.ref_len + b0 + wl);
    s.pre_ok = valid && ((cw >> (s.safe & 31)) & 1u) == 0;
    s.clen = (int)(lenw & 0x7FFFFFFFu);
    slot_range(s, kf_raw, sb, rl);
    if (base == 0) {
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    const uint32_t* f = sfr + wl * fw + s.kf * a.W;
    int ham = 0;
    if (W7) {
      const uint32_t rw[7] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z};
#pragma unroll
      for (int w = 0; w < 7; ++w) ham += ham_word(f[w], rw[w], s.lo, s.hi, w);
    } else {
      for (int w = 0; w < a.W; ++w)
        ham += ham_word(f[w], __ldg(row + w), s.lo, s.hi, w);
    }
    if (act) store_slot(a, i, s, ham);
  }
}

template <typename K>
cudaError_t launch_verify(K kernel, const VerifyArgs& a, int blocks,
                          int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The most dynamic shared memory a block may opt into on sm_90.
constexpr size_t kMaxSmem = 227 * 1024;

cudaError_t verify_rows(VerifyArgs a, cudaStream_t stream) {
  if (a.B <= 0 || a.M <= 0) return cudaSuccess;
  if (a.W <= 0 || a.F <= 0 || a.Np <= 0) return cudaErrorInvalidValue;
  // a block owns whole walkers: as many as fill 128 outputs and as their
  // frames fit into shared memory, at least one
  const size_t walker_smem = (size_t)a.F * a.W * sizeof(uint32_t);
  a.wpb = max(1, min(128 / a.M, (int)(kMaxSmem / walker_smem)));
  const int threads = min(max((a.wpb * a.M + 31) / 32 * 32, 32), 128);
  const int blocks = (a.B + a.wpb - 1) / a.wpb;
  const size_t smem = a.wpb * walker_smem;
  const bool w7 = a.W == 7 &&
                  (reinterpret_cast<uintptr_t>(a.rows_tab) & 15) == 0;
  return w7 ? launch_verify(verify_rows_kernel<true>, a, blocks, threads,
                            smem, stream)
            : launch_verify(verify_rows_kernel<false>, a, blocks, threads,
                            smem, stream);
}

cudaError_t masked_hamming(const void* frames, const void* rows,
                           const void* lo, const void* hi, void* out,
                           int64_t n, int W, int64_t f_word, int64_t f_row,
                           int64_t r_word, int64_t r_row,
                           cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  auto kernel = W == 7 ? masked_hamming_kernel<7> : masked_hamming_kernel<0>;
  kernel<<<blocks, threads, 0, stream>>>(
      (const uint32_t*)frames, (const uint32_t*)rows, (const int32_t*)lo,
      (const int32_t*)hi, (int32_t*)out, n, W, f_word, f_row, r_word, r_row);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

// The device's time of one launch: `launch` is captured `reps` times into
// a CUDA graph (after one plain launch, which also loads the kernel), the
// graph is replayed once to warm up and once between two events on
// `stream`; *ms is that replay's time over reps. A replayed graph runs its
// kernels one after another with no host call between them; launches
// made one by one, even from C, are paced by the host (an empty kernel
// then takes longer than the fused kernel's bound).
template <typename L>
cudaError_t timed(L launch, int reps, float* ms, cudaStream_t stream) {
  if (reps <= 0 || ms == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = launch(stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  if (e != cudaSuccess) return e;
  cudaStream_t cap = nullptr;
  e = cudaStreamCreateWithFlags(&cap, cudaStreamNonBlocking);
  if (e != cudaSuccess) return e;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaEvent_t start = nullptr, stop = nullptr;
  e = cudaStreamBeginCapture(cap, cudaStreamCaptureModeThreadLocal);
  if (e == cudaSuccess) {
    for (int r = 0; r < reps && e == cudaSuccess; ++r) e = launch(cap);
    const cudaError_t end = cudaStreamEndCapture(cap, &graph);
    if (e == cudaSuccess) e = end;
  }
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, graph, 0);
  if (e == cudaSuccess) e = cudaEventCreate(&start);
  if (e == cudaSuccess) e = cudaEventCreate(&stop);
  if (e == cudaSuccess) e = cudaGraphLaunch(exec, stream);
  if (e == cudaSuccess) e = cudaEventRecord(start, stream);
  if (e == cudaSuccess) e = cudaGraphLaunch(exec, stream);
  if (e == cudaSuccess) e = cudaEventRecord(stop, stream);
  if (e == cudaSuccess) e = cudaEventSynchronize(stop);
  float total = 0.f;
  if (e == cudaSuccess) e = cudaEventElapsedTime(&total, start, stop);
  *ms = total / reps;
  if (start) cudaEventDestroy(start);
  if (stop) cudaEventDestroy(stop);
  if (exec) cudaGraphExecDestroy(exec);
  if (graph) cudaGraphDestroy(graph);
  cudaStreamDestroy(cap);
  return e;
}

// Makes `device` current for the scope (the launch goes to the card that
// holds the tensors, whatever the caller's current device is). A CUDA
// graph's capture runs with that card current (ops/graphs.py), so under
// capture the scope only reads the current device; and at the reorder
// round's shapes a verify block needs under 48 KB of shared memory, so
// launch_verify makes no attribute call there either.
struct DeviceScope {
  int prev = -1;
  bool moved = false;
  explicit DeviceScope(int device) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != device)
      moved = cudaSetDevice(device) == cudaSuccess;
  }
  ~DeviceScope() {
    if (moved) cudaSetDevice(prev);
  }
};

VerifyArgs verify_args(const void* rows_tab, const void* cand,
                       const void* valid, const void* claimed,
                       const void* frames, const void* k_frame,
                       const void* shift_base, const void* ref_len, void* ok,
                       void* t, void* clen, void* ham, int B, int M, int W,
                       int F, int Np, int thresh) {
  VerifyArgs a;
  a.rows_tab = (const uint32_t*)rows_tab;
  a.cand = (const int32_t*)cand;
  a.valid = (const uint8_t*)valid;
  a.claimed = (const uint32_t*)claimed;
  a.frames = (const uint32_t*)frames;
  a.k_frame = (const int32_t*)k_frame;
  a.shift_base = (const int32_t*)shift_base;
  a.ref_len = (const int32_t*)ref_len;
  a.ok = (uint8_t*)ok;
  a.t = (int32_t*)t;
  a.clen = (int32_t*)clen;
  a.ham = (int32_t*)ham;
  a.B = B;
  a.M = M;
  a.W = W;
  a.F = F;
  a.Np = Np;
  a.thresh = thresh;
  a.wpb = 1;
  return a;
}

}  // namespace

// Every entry launches on `stream` (PyTorch's current stream) of card
// `device` and returns a cudaError_t as an int: 0 when the launch was
// accepted. `out` of stpu_verify_rows is one buffer of 13 * B * M bytes:
// ham, t, clen as int32 (B, M) each, then ok as one byte a slot.

extern "C" int stpu_verify_rows(const void* rows_tab, const void* cand,
                                const void* valid, const void* claimed,
                                const void* frames, const void* k_frame,
                                const void* shift_base, const void* ref_len,
                                void* out, int B, int M, int W, int F, int Np,
                                int thresh, int device, void* stream) {
  DeviceScope scope(device);
  const size_t n = (size_t)B * M;
  char* o = (char*)out;
  return (int)verify_rows(
      verify_args(rows_tab, cand, valid, claimed, frames, k_frame,
                  shift_base, ref_len, o + 12 * n, o + 4 * n, o + 8 * n, o,
                  B, M, W, F, Np, thresh),
      (cudaStream_t)stream);
}

extern "C" int stpu_verify_rows_timed(
    const void* rows_tab, const void* cand, const void* valid,
    const void* claimed, const void* frames, const void* k_frame,
    const void* shift_base, const void* ref_len, void* out, int B, int M,
    int W, int F, int Np, int thresh, int device, void* stream, int reps,
    float* ms) {
  DeviceScope scope(device);
  const size_t n = (size_t)B * M;
  char* o = (char*)out;
  const VerifyArgs a = verify_args(rows_tab, cand, valid, claimed, frames,
                                   k_frame, shift_base, ref_len, o + 12 * n,
                                   o + 4 * n, o + 8 * n, o, B, M, W, F, Np,
                                   thresh);
  return (int)timed(
      [&](cudaStream_t s) { return verify_rows(a, s); }, reps, ms,
      (cudaStream_t)stream);
}

extern "C" int stpu_masked_hamming(const void* frames, const void* rows,
                                   const void* lo, const void* hi, void* out,
                                   int64_t n, int W, int64_t f_word,
                                   int64_t f_row, int64_t r_word,
                                   int64_t r_row, int device, void* stream) {
  DeviceScope scope(device);
  return (int)masked_hamming(frames, rows, lo, hi, out, n, W, f_word, f_row,
                             r_word, r_row, (cudaStream_t)stream);
}

extern "C" int stpu_masked_hamming_timed(
    const void* frames, const void* rows, const void* lo, const void* hi,
    void* out, int64_t n, int W, int64_t f_word, int64_t f_row,
    int64_t r_word, int64_t r_row, int device, void* stream, int reps,
    float* ms) {
  DeviceScope scope(device);
  return (int)timed(
      [&](cudaStream_t s) {
        return masked_hamming(frames, rows, lo, hi, out, n, W, f_word, f_row,
                              r_word, r_row, s);
      },
      reps, ms, (cudaStream_t)stream);
}

// The floor of that timing: an empty kernel of one warp.
extern "C" int stpu_empty_timed(int device, void* stream, int reps,
                                float* ms) {
  DeviceScope scope(device);
  return (int)timed(
      [](cudaStream_t s) {
        empty_kernel<<<1, 32, 0, s>>>();
        return cudaGetLastError();
      },
      reps, ms, (cudaStream_t)stream);
}
