"""The NA12878 configuration (2x151 bp, binned qualities, reads with N):
its cell's lookup, its generator output, the second-chance metrics'
readers, and a tiny 151 bp cell end to end on the CPU."""
import json
import os

import pytest

import run
from harness import spec, synth
from harness.cell import Run
from harness.trace import Trace
from spring_tpu_torch.encode import second_chance as sc
from spring_tpu_torch.utils import spans as program

SEED = 2**31 + 151
CELL = "na12878_pe151_lossless.wgs27x"
MS = 1_000_000          # ns


def _read(name, run_):
    return spec.reader(name).read(run_)


def test_new_cell_loads():
    s = spec.load()
    wgs = spec.cell(s, CELL)
    assert wgs["workload"]["chips"] == 1
    assert wgs["config"]["guarantee"] == {"order": True, "ids": True,
                                          "qualities": True}
    assert wgs["config"]["control"] == {"quality_mode": "ill_bin"}
    assert set(wgs["config"]["reduced"]) == {"pairs", "genome_size"}
    t = wgs["traffic"]
    assert (t["read_len"], t["qual_levels"], t["pairs"]) == (151, 8, 2000000)
    # the published depth: 2 x 2,000,000 x 151 bases over the window
    assert 2 * t["pairs"] * t["read_len"] / t["genome_size"] == \
        pytest.approx(27.30, abs=0.01)
    names = {m["name"] for m in s["per_layer"]}
    assert {"encode.second_chance_device_busy_pct",
            "encode.second_chance_placed_pct"} <= names


def test_wgs27x_writes_151_base_records_with_n(tmp_path):
    traffic = dict(spec.cell(spec.load(), CELL)["traffic"], pairs=200,
                   genome_size=2212)
    files = [str(tmp_path / "a.fq"), str(tmp_path / "b.fq")]
    synth.generate(traffic, SEED, files)
    lines = [ln for f in files for ln in open(f, "rb").read().split(b"\n")
             if ln]
    seqs, quals = lines[1::4], lines[3::4]
    assert len(seqs) == 400 and {len(s) for s in seqs} == {151}
    assert {len(q) for q in quals} == {151}
    assert set(b"".join(quals)) <= set(synth.QLEVELS)
    # 0.000115 a base: ~1.7% of reads carry one, ~7 of 400
    assert 1 <= sum(b"N" in s for s in seqs) <= 20


def _run(stats, spans_ms=(), ranges_ms=(), ops_ms=()):
    """A Run of compresses with these engine counters; traced where
    ``ranges_ms`` is given."""
    r = Run(workload={}, config={}, traffic={}, reads=1, bases=1)
    r.compresses = [dict(stages={}, engine=e) for e in stats]
    if ranges_ms:
        r.trace = Trace(ops=[("k", s * 1000, e * 1000) for s, e in ops_ms],
                        compresses=[(a * 1000, b * 1000)
                                    for a, b in ranges_ms])
    return r


def test_placed_pct_sums_the_window():
    r = _run([{"second_chance_in": 100, "second_chance_placed": 90},
              {"second_chance_in": 300, "second_chance_placed": 250}])
    assert _read("encode.second_chance_placed_pct", r) == \
        pytest.approx(100 * 340 / 400)
    # none given, or a program without the counters: nothing to read
    assert _read("encode.second_chance_placed_pct", _run(
        [{"second_chance_in": 0, "second_chance_placed": 0}])) is None
    assert _read("encode.second_chance_placed_pct",
                 _run([{"unmatched": 3}, {}])) is None


def _sc(sid, c, start_ms, end_ms, name="second_chance"):
    return program.Span(sid, None, c, name, "encode", "t", start_ms * MS,
                        end_ms * MS, {})


def test_second_chance_busy_reads_the_stage_span(monkeypatch):
    # a warm-up compress before the window, then two in it: second chance
    # 100 ms each, busy 40 then 10 ms of it; ops elsewhere count nowhere
    got = [_sc(1, 1, 0, 100), _sc(2, 2, 1100, 1200), _sc(3, 3, 2100, 2200),
           _sc(4, 2, 1000, 1100, name="reorder_run")]
    r = _run([{}, {}], ranges_ms=[(990, 1300), (1990, 2300)],
             ops_ms=[(1090, 1120), (1110, 1140), (2195, 2205), (1000, 1090),
                     (10, 90)])
    monkeypatch.setattr(program, "spans", lambda: got)
    name = "encode.second_chance_device_busy_pct"
    assert _read(name, r) == pytest.approx((40 + 5) / 2)
    r.trace.ops = []                    # a CPU trace
    assert _read(name, r) is None
    r.trace.ops = [("k", 1100 * 1000, 1101 * 1000)]
    monkeypatch.setattr(program, "spans", lambda: got[3:])   # no stage
    assert _read(name, r) is None
    r.trace = None                      # an untraced run
    assert _read(name, r) is None


def _tiny151(root):
    """A cell of the NA12878 configuration on a tiny wgs27x in ``root``."""
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", "wgs27x.json")) as f:
        traffic = dict(json.load(f), pairs=250, genome_size=2770,
                       n_rate=0.0005)
    with open(os.path.join(bench, "traffic", "tiny151.json"), "w") as f:
        json.dump(traffic, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        s = json.load(f)
    s["workloads"].append({"name": "na12878_pe151_lossless.tiny151",
                           "config": "na12878_pe151_lossless",
                           "traffic": "tiny151", "chips": 1, "why": "t"})
    with open(path, "w") as f:
        json.dump(s, f)
    return "na12878_pe151_lossless.tiny151"


def test_tiny_151_cell_is_correct_and_counts(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(sc, "SEG_BASES", 1 << 14)
    workload = _tiny151(tiny_root)
    args = run.parse(["--workload", workload, "--seed", str(SEED),
                      "--seconds", "0.1", "--trace", "1"])
    assert run.report(args, "cpu", tiny_root) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["checks"].values())
    got = line["metrics"]
    assert 0 < got["encode.second_chance_placed_pct"]["value"] <= 100
    # no device operation on the CPU
    assert "encode.second_chance_device_busy_pct" not in got
