"""spring_tpu_torch — the PyTorch/CUDA port of spring_tpu.

The device stages of short-read compress (dictionary build, reorder rounds,
second-chance matching) run as PyTorch tensor code on an explicit device;
the masked-Hamming verify of the reorder round is a hand-written CUDA
kernel (csrc/masked_hamming.cu). Host stages that hold no JAX (FASTQ
parse, consensus, codecs, container, decompress) are imported from
spring_tpu as they are. Nothing here imports jax.
"""
