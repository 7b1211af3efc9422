"""Synthetic FASTQ generator shared with spring_tpu (host numpy code):
SRR554369-class reads over a random genome, made from a seed."""
from spring_tpu.utils.synth import make_pe, make_se

__all__ = ["make_pe", "make_se"]
