// Masked Hamming distance over 2-bit packed DNA words, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spring_tpu/ops/pallas_kernels.py::
// masked_hamming (body _ham_kernel, range mask _prefix_word). For each
// output element i it counts the 2-bit bases in [lo[i], hi[i]) where
// frames and rows differ: XOR, fold each lane pair onto its low bit
// ((d | d >> 1) & 0x55555555), AND with the range mask of the word,
// popcount, and sum over the W words.
//
// Design: one thread per output element, looping over the W words in
// registers; the masks are computed in registers. The TPU kernel's
// 256-row VMEM blocks have no counterpart here. At the reorder round's
// shape (B=4096 walkers x M=16 slots x W=7 words) a call reads about 4 MB
// and does a handful of integer operations per word, so it is bound by
// memory bandwidth and, at these small sizes, by launch latency. Strides
// are passed in elements, so both the word-major (W, B, K) layout of the
// JAX kernel and the round's gathered row-major (B, M, W+1) rows reach the
// kernel without a copy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see spring_tpu_torch/ops/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Mask of the first nb (0..16) 2-bit lanes of a word; never shifts by 32.
__device__ __forceinline__ uint32_t prefix_word(int nb) {
  return nb > 0 ? (0xFFFFFFFFu >> (32 - 2 * nb)) : 0u;
}

__global__ void masked_hamming_kernel(const uint32_t* __restrict__ frames,
                                      const uint32_t* __restrict__ rows,
                                      const int32_t* __restrict__ lo,
                                      const int32_t* __restrict__ hi,
                                      int32_t* __restrict__ out, int64_t n,
                                      int W, int64_t f_word, int64_t f_row,
                                      int64_t r_word, int64_t r_row) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int l = lo[i];
  const int h = hi[i];
  const uint32_t* f = frames + i * f_row;
  const uint32_t* r = rows + i * r_row;
  int acc = 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t d = f[w * f_word] ^ r[w * r_word];
    const uint32_t m = (d | (d >> 1)) & 0x55555555u;
    const int nh = min(max(h - 16 * w, 0), 16);
    const int nl = min(max(l - 16 * w, 0), 16);
    acc += __popc(m & prefix_word(nh) & ~prefix_word(nl));
  }
  out[i] = acc;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int stpu_masked_hamming(const void* frames, const void* rows,
                                   const void* lo, const void* hi, void* out,
                                   int64_t n, int W, int64_t f_word,
                                   int64_t f_row, int64_t r_word,
                                   int64_t r_row, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  masked_hamming_kernel<<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)frames, (const uint32_t*)rows, (const int32_t*)lo,
      (const int32_t*)hi, (int32_t*)out, n, W, f_word, f_row, r_word, r_row);
  return (int)cudaGetLastError();
}
