"""Command-line interface of the port: spring_tpu's flags plus --device.

    python -m spring_tpu_torch.cli -c -i in.fastq -o out.stpu --device cuda
    python -m spring_tpu_torch.cli -d -i out.stpu -o out.fastq
"""
from __future__ import annotations

import argparse
import sys

from spring_tpu.cli import build_parser as _tpu_parser
from spring_tpu.cli import parse_quality_opts

from . import api


def build_parser() -> argparse.ArgumentParser:
    p = _tpu_parser()
    p.prog = "spring-tpu-torch"
    p.description = "FASTQ/FASTA compressor (SPRING-class), PyTorch/CUDA port"
    p.add_argument("--device", default="cuda",
                   help="torch device of the compress device stages "
                        "(default cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.compress:
            qmode, qratio, qthr = parse_quality_opts(args.quality_opts)
            opts = api.CompressOptions(
                reorder=args.allow_read_reordering,
                preserve_quality=not args.no_quality,
                preserve_id=not args.no_ids,
                long_mode=args.long,
                fasta_input=args.fasta_input,
                quality_mode=qmode, qvz_ratio=qratio, bin_thresholds=qthr,
                num_threads=args.num_threads,
                verbose=not args.quiet)
            if len(args.output_file) != 1:
                raise SystemExit("compression writes exactly 1 archive")
            api.compress(args.input_file, args.output_file[0], opts,
                         device=args.device)
        else:
            rng = None
            if args.decompress_range:
                lo, hi = args.decompress_range
                rng = (lo - 1, hi)  # CLI is 1-based inclusive
            if len(args.input_file) != 1:
                raise SystemExit("decompression reads exactly 1 archive")
            api.decompress(args.input_file[0], args.output_file,
                           gzipped=args.gzipped_fastq,
                           num_threads=args.num_threads,
                           read_range=rng, verbose=not args.quiet)
        return 0
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
