"""The port on the shape of SPRING's NA12878 run (2x151 bp, binned
qualities, reads with N): a lossless round trip on the CPU, held to the
guarantee by the benchmark's plain reference, and the second-chance
counters and span attributes of short_mode.

The input comes from the benchmark's generator with the keys of
``benchmark/traffic/wgs27x.json``, cut to 250 pairs at ~27x over a
2,770 bp genome, with ``n_rate`` raised so that ~7% of reads carry an N.
The engine's rounds, ~20-30 ms each on the CPU, take most of its time.
"""
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import synth  # noqa: E402
from reference import records  # noqa: E402

from spring_tpu_torch import api  # noqa: E402
from spring_tpu_torch.encode import second_chance as sc  # noqa: E402
from spring_tpu_torch.pipeline import short_mode  # noqa: E402
from spring_tpu_torch.reorder import engine as eng  # noqa: E402
from spring_tpu_torch.utils import spans  # noqa: E402

PAIRS = 250
GENOME = 2770           # 250 x 302 bases / 2,770 = 27.3x


def _traffic():
    with open(os.path.join(BENCH, "traffic", "wgs27x.json")) as f:
        t = json.load(f)
    t.update(pairs=PAIRS, genome_size=GENOME, n_rate=0.0005)
    return t


def _n_records(path: str) -> int:
    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    return sum(b"N" in s for s in seqs)


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe151")
    ins = [str(d / f"in_{m}.fastq") for m in (1, 2)]
    outs = [str(d / f"out_{m}.fastq") for m in (1, 2)]
    synth.generate(_traffic(), 20, ins, workers=1)
    arc = str(d / "a.stpu")
    with pytest.MonkeyPatch.context() as mp:
        # the matchers' consensus words are padded to SEG_BASES positions
        # (2^24 by default, seconds a call here); a small pad keeps every
        # path of stitch and second chance at a fraction of the time
        mp.setattr(sc, "SEG_BASES", 1 << 14)
        api.compress(ins, arc, api.CompressOptions(num_threads=2,
                                                   verbose=False),
                     device="cpu")
    stats = dict(eng.LAST_RUN_STATS)
    stage = [s for s in spans.spans()
             if s.name == "second_chance" and s.parent is None][-1]
    api.decompress(arc, outs, num_threads=2, verbose=False)
    return ins, outs, stats, stage


def test_pe151_round_trip_is_lossless(round_trip):
    ins, outs, _, _ = round_trip
    with open(ins[0], "rb") as f:
        first = f.read().split(b"\n")
    assert len(first[1]) == 151 and set(first[3]) <= set(synth.QLEVELS)
    faults = records.compare(ins, outs, {"order": True, "ids": True,
                                         "qualities": True})
    assert faults and all(v == 0 for v in faults.values()), faults


def test_second_chance_counters_and_span(round_trip):
    ins, _, stats, stage = round_trip
    n_reads = sum(_n_records(p) for p in ins)
    assert n_reads >= 20
    assert stats["n_reads"] == n_reads
    assert stats["second_chance_in"] >= stats["n_reads"]
    assert 0 <= stats["second_chance_placed"] <= stats["second_chance_in"]
    assert stats["second_chance_placed"] > 0
    assert stage.attrs == {"n_reads": stats["n_reads"],
                           "reads_in": stats["second_chance_in"],
                           "placed": stats["second_chance_placed"]}
    assert short_mode.STAGE_LAYERS[stage.name] == stage.layer == "encode"
    assert np.isfinite(short_mode.LAST_STAGE_SECONDS["second_chance"])
