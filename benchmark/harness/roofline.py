"""The least time the card could take for a kernel's work: the table of
peaks and the byte and operation counts of the port's kernels.

A frozen copy of chip_smoke.py's HBM_BYTES_PER_S, ALU_OPS_PER_S,
OPS_PER_WORD, OPS_PER_SLOT, _bound and verify_bound as of commit
b2b9e62. verify_bound took the round's tensors; this copy takes the
round's shape, and leaves out the bytes of the walkers' frames that the
slots name, which depend on data the trace does not see. It counts fewer
bytes than the kernel must move, so the share of the roofline that it
gives is a lower bound of the true share, and cannot pass 100%.
"""
from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float32 rate outside the tensor cores, taken here as the rate of
# the kernel's 32-bit integer operations
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# masked Hamming, per packed word: xor, shift, or, and (fold); two prefix
# masks of a subtract, a clamp and a shift each, a not and an and; the
# final and, popcount and add
OPS_PER_WORD = 14
# the fused verify, per slot beside its words: clamp the id, the row's
# address, the bitmap test, the length mask, the shift, lo/hi/t, the accept
OPS_PER_SLOT = 22
BASES_PER_WORD = 16      # 2-bit bases in a packed 32-bit word


def bound(nbytes: int, ops: int) -> dict:
    """The least time (s) the card could take to move nbytes and do ops
    integer operations, against the published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ALU_OPS_PER_S
    return dict(bytes=nbytes, ops=ops, bound_s=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def verify_rows_bound(B: int, M: int, W: int) -> dict:
    """Bound of one fused verify (``verify_rows_kernel``) of B walkers
    with M candidate slots each over rows of W packed words. Every input
    is read once and every output written once: per slot its row (W + 1
    words), the candidate id, the frame index, one bitmap word, the
    valid byte in; ham, t, clen and the ok byte out; per walker its
    ref_len and shift_base."""
    n = B * M
    nbytes = n * ((W + 1) * 4 + 4 + 4 + 4 + 1 + 3 * 4 + 1) + 2 * B * 4
    return bound(nbytes, n * (W * OPS_PER_WORD + OPS_PER_SLOT))
