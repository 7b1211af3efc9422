"""Command-line interface of the port: spring_tpu's flags plus --device.

    python -m spring_tpu_torch.cli -c -i in.fastq -o out.stpu --device cuda
    python -m spring_tpu_torch.cli -d -i out.stpu -o out.fastq

Copy of spring_tpu/cli.py. Reference analog: src/main.cpp:49-96
(boost::program_options flags): -c/-d, -i, -o, -t, -r, -l, -q, -g,
--fasta-input, --no-quality, --no-ids, --decompress-range, -w (working
dir, unused here: we stream in-process and have no temp-dir lifecycle to
manage).
"""
from __future__ import annotations

import argparse
import sys

from . import api


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spring-tpu-torch",
        description="FASTQ/FASTA compressor (SPRING-class), PyTorch/CUDA "
                    "port")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-c", "--compress", action="store_true")
    mode.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-i", "--input-file", nargs="+", required=True,
                   help="input file(s): 1 for SE, 2 for PE")
    p.add_argument("-o", "--output-file", nargs="+", required=True,
                   help="output file(s)")
    p.add_argument("-t", "--num-threads", type=int, default=8)
    p.add_argument("-w", "--working-dir", default=None,
                   help="accepted for SPRING CLI compatibility; this "
                        "implementation streams in-process and needs no "
                        "temp directory")
    p.add_argument("-r", "--allow-read-reordering", action="store_true",
                   help="do not retain read order (better compression)")
    p.add_argument("-l", "--long", action="store_true",
                   help="long-read mode (no length limit; reads stored raw)")
    p.add_argument("-q", "--quality-opts", nargs="+", default=["lossless"],
                   help="lossless | qvz <ratio> | ill_bin | binary <t> <hi> <lo>")
    p.add_argument("-g", "--gzipped-fastq", action="store_true",
                   help="gzip decompressed output")
    p.add_argument("--fasta-input", action="store_true")
    p.add_argument("--no-quality", action="store_true")
    p.add_argument("--no-ids", action="store_true")
    p.add_argument("--decompress-range", nargs=2, type=int, metavar=("START", "END"),
                   help="decompress reads START..END (1-based, inclusive)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the compress device stages "
                        "(default cuda)")
    return p


def parse_quality_opts(tokens: list[str]):
    mode = tokens[0]
    if mode == "lossless":
        return "lossless", 8.0, ()
    if mode == "qvz":
        if len(tokens) != 2:
            raise SystemExit("-q qvz needs a ratio argument")
        return "qvz", float(tokens[1]), ()
    if mode == "ill_bin":
        return "ill_bin", 8.0, ()
    if mode == "binary":
        if len(tokens) != 4:
            raise SystemExit("-q binary needs: threshold high low")
        return "binary", 8.0, tuple(int(t) for t in tokens[1:4])
    raise SystemExit(f"unknown quality mode {mode}")


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
