"""spring_tpu_torch — the PyTorch/CUDA port of spring_tpu.

The device stages of short-read compress (dictionary build, reorder rounds,
second-chance matching) run as PyTorch tensor code on an explicit device;
the masked-Hamming verify of the reorder round is a hand-written CUDA
kernel (csrc/masked_hamming.cu). The host stages (FASTQ parse, consensus,
codecs, container, long mode, decompress) are the package's own copies of
spring_tpu's, over its own native library (csrc/host/). Nothing here
imports jax or spring_tpu.
"""


def _raise_mmap_threshold() -> None:
    """Keep big numpy buffers in the malloc arena instead of per-allocation
    mmaps. glibc mmaps allocations over 128 KB and unmaps them on free, so
    every block-sized matrix the pipeline allocates refaults its pages,
    which swings the host stages' times between runs. Raising
    M_MMAP_THRESHOLD lets freed buffers be reused with their pages still
    resident (copy of spring_tpu/__init__.py::_raise_mmap_threshold)."""
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 29)
    except (OSError, AttributeError):   # non-glibc platform: only a speed-up
        pass


_raise_mmap_threshold()
