"""Copied from spring_tpu/params.py; only the imports differ.

Tuning constants and runtime compression parameters.

Reference analog: src/params.h:22-37 (compile-time constants) and the
``compression_params`` struct at src/util.h:30-51. We keep the same knobs
but as a versioned dataclass serialized to JSON in the archive manifest
(the reference dumps a raw C struct, src/spring.cpp:217-221, which is
ABI-fragile — deliberately not reproduced).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

FORMAT_MAGIC = "SPRING-TPU"
FORMAT_VERSION = 5   # v2: id streams use 15-bit range-coder probabilities;
                     # qv shards may carry the fine-position-context flag
                     # v3: long-mode read streams carry a mode byte (raw
                     # str-array wire vs 2-bit packed ACGT); qv shards may
                     # use the constant-prefix wire mode
                     # v4: id streams use count-based type/len/digit models
                     # (with template + T_DUP wire additions); v2-v3 id
                     # streams would mis-decode, so older archives are
                     # refused rather than corrupted
                     # v5: optional super-shard container for inputs past
                     # the per-shard read cap (manifest carries
                     # shard_reads; members live under sh<j>/ with a
                     # per-shard manifest). v4 archives read unchanged.

# --- short-read mode limits (reference src/params.h:22-24) ---
MAX_READ_LEN = 511            # short mode limit; long mode is unlimited
# Read ids are int32 throughout the device pipeline (emissions, layouts,
# dictionaries), so one COMPRESSION SHARD holds at most int32-many
# reads. Inputs past this are split into independent super-shards inside
# one archive (short_mode.compress_short; PARITY.md "Beyond 2^31
# reads"), exceeding the reference's uint32 ceiling (src/params.h:24).
# Long mode is block-streamed and has no read-count limit.
MAX_NUM_READS_SHORT = 2**31 - 2

# --- dictionary configuration (reference src/params.h:25-27 uses 2 dicts
#     over windows around the read midpoint). We use 2 fixed-width hash
#     windows of KEY_BASES=16 bases each (reorder/dictionary.py).
NUM_DICTS = 2

# --- matching thresholds (reference src/params.h:30-33) ---
THRESH_REORDER = 4            # max Hamming distance to join a contig
THRESH_ENCODER = 24           # max Hamming distance in second-chance alignment
MAX_SHIFT_CAP = 24            # shift-scan cap (reference scans maxlen/2;
                              # see ReorderConfig.max_shift)
MIN_CONTIG_READS = 2          # contigs below this read count are demoted:
                              # their reads re-place via second chance
                              # (low-coverage contigs are legitimately
                              # short: K>2 helped 50x coverage by 0.1% but
                              # cost 1.6% at 5x — default stays 2)

# --- blocking (reference src/params.h:35-36) ---
NUM_READS_PER_BLOCK = 256000        # short mode block (random-access unit)
NUM_READS_PER_BLOCK_LONG = 10000    # long mode block
# (entropy codec block size lives at its point of use: codecs/bsc.py
# DEFAULT_BLOCK — 4 MB blocks measured better than the reference's 64 MB
# on these stream sizes and parallelize across cores)

# --- TPU batch geometry (no reference analog; ours) ---
# max parallel contig walkers per device. On-chip sweep at 10M reads
# (2026-08-20): B=8192 beats 16384 on rounds wall (20.3 vs 23.7 s),
# seed count (326k vs 349k), and archive bytes (348.02 vs 348.21 MB);
# 4096 is smaller still on bytes but its 960 rounds pay the per-round
# floor (34 s), and 65536 loses everywhere. 1M keeps B=4096 via the
# ~256-reads-per-walker auto rule.
REORDER_BATCH = 8192
DICT_PROBE_CANDIDATES = 2     # candidates fetched per selected probe group.
                              # Bins are shallow (a bin = reads starting at
                              # ONE genome position, ~coverage/readlen
                              # entries), so narrow fetches across MORE
                              # groups beat wide fetches: C=2 x 8 groups
                              # matched C=8 x 2 groups' claims at 0.65x the
                              # round time (A/B-measured at 1M reads)
                              # (bin scan cap; compaction refreshes bins)

QUALITY_MODES = ("lossless", "qvz", "ill_bin", "binary")


@dataclasses.dataclass
class CompressionParams:
    """Runtime parameters stored in the archive manifest.

    Mirrors reference compression_params (src/util.h:30-51): paired_end,
    preserve_order, preserve_quality, preserve_id, long_flag, quality mode
    and its parameters, num_reads, read length stats, block sizes.
    """
    paired_end: bool = False
    preserve_order: bool = True
    preserve_quality: bool = True
    preserve_id: bool = True
    long_mode: bool = False
    fasta_input: bool = False
    quality_mode: str = "lossless"       # one of QUALITY_MODES
    qvz_ratio: float = 8.0
    bin_thresholds: tuple = ()           # for binary thresholding mode
    num_reads: int = 0
    num_reads_clean: int = 0             # reads with only ACGT
    max_readlen: int = 0
    num_reads_per_block: int = NUM_READS_PER_BLOCK
    num_reads_per_block_long: int = NUM_READS_PER_BLOCK_LONG
    num_blocks: int = 0
    paired_id_code: int = 0              # PE id pattern (0=none, 1..3)
    paired_id_match: bool = False
    # super-shard container: per-shard TOTAL read counts (empty = plain
    # single-shard archive). Shard j's members live under "sh<j>/" with
    # their own manifest; this top-level manifest only routes.
    shard_reads: tuple = ()
    version: int = FORMAT_VERSION

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["bin_thresholds"] = list(d["bin_thresholds"])
        d["shard_reads"] = list(d["shard_reads"])
        d["magic"] = FORMAT_MAGIC
        return json.dumps(d, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CompressionParams":
        d = json.loads(s)
        magic = d.pop("magic", None)
        if magic != FORMAT_MAGIC:
            raise ValueError(f"not a {FORMAT_MAGIC} archive (magic={magic!r})")
        if d.get("version", 0) > FORMAT_VERSION:
            raise ValueError(f"archive version {d['version']} is newer than "
                             f"this library ({FORMAT_VERSION})")
        if d.get("version", 0) < 4:
            # earlier id-stream coders (v1: 12-bit probs; v2-v3: EMA
            # token models) would silently mis-decode under the v4
            # count-based models; refuse instead
            raise ValueError(
                f"archive format v{d.get('version', 0)} predates the v4 "
                "stream coders and cannot be read by this build")
        d["bin_thresholds"] = tuple(d.get("bin_thresholds", ()))
        d["shard_reads"] = tuple(d.get("shard_reads", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
