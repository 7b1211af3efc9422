"""tools/knob_sweep_torch.py and tools/sweep_probe_torch.py on the CPU.

The knob tool's flushes against the JAX engine's flush program driven the
same way (spring_tpu/reorder/engine.py, its four-value return: state,
dense emissions, counts, stats), exactly; the sweep tool's lines against
the port's api.compress with the same CompressOptions.engine; both
tools' argument checks, and their refusal to run without a card when
asked for one.
"""
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import knob_sweep_torch as knob  # noqa: E402
import sweep_probe_torch as sweep  # noqa: E402

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from spring_tpu.reorder import dictionary as jdct  # noqa: E402
from spring_tpu.reorder import engine as jeng  # noqa: E402


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    """4,096 reads of 100 bases at ~50x of an 8,000-base genome (the
    engine's B = 16 walkers, Np = 4,096)."""
    from spring_tpu_torch.utils import synth
    path = str(tmp_path_factory.mktemp("sweep") / "in.fastq")
    synth.make_se(path, 4096, read_len=100, genome_size=8000, seed=42)
    return path


def _lines(text):
    return [json.loads(x) for x in text.strip().splitlines()]


def _jax_flushes(packed, lengths, maxlen, kw, flushes=3):
    """The JAX engine's setup of its run, then ``flushes`` calls of its
    flush program; returns each flush's stats and the claimed reads."""
    e = jeng.ReorderEngine(packed, lengths,
                           jeng.ReorderConfig(max_readlen=maxlen, **kw))
    state = e._init_state()
    rows_tab = state.pop("rows")
    e._build_dicts(rows_tab)
    dkeys = jnp.concatenate([d.btab for d in e._dicts], axis=0)
    pairs_all = jnp.concatenate([jdct.pairs_from_rids(d.rids)
                                 for d in e._dicts], axis=0)
    stride = max(e.N // e.B, 1)
    idx = np.arange(e.N, dtype=np.int32)
    so = np.concatenate([idx[r::stride] for r in range(stride)])
    so = np.concatenate([so, np.full(e.Np - len(so), e.Np - 1, np.int32)])
    args = (e.lengths, dkeys, pairs_all, jnp.asarray(so),
            jnp.asarray(e.N, jnp.int32),
            jnp.asarray(e.cfg.max_shift, jnp.int32), rows_tab)
    stats = []
    for _ in range(flushes):
        state, _dense, _cnt, st = e._round_fn(state, *args)
        stats.append([int(x) for x in np.asarray(st)])
    return stats, stats[-1][0] - (e.Np - e.N), e.B


@pytest.mark.parametrize("variant,kw", [("baseline", {}),
                                        ("shift_chunk=8",
                                         {"shift_chunk": 8})])
def test_knob_flushes_equal_jax(fq, capsys, variant, kw):
    """The knob tool's line for the variant: its three flushes' stats and
    claimed reads equal the JAX flush program's on the same packed
    reads; the engine run's numbers are there (no capture on the CPU)."""
    from spring_tpu_torch.io import fastq_native
    from spring_tpu_torch.ops import graphs
    # a program of the same key left by another test file in this worker
    # process would turn the engine run's cache miss into a hit
    graphs.clear_program_cache()
    rc = knob.main(["4096", variant, "--device", "cpu", "--fastq", fq,
                    "--threads", "2"])
    head, rec = _lines(capsys.readouterr().out)
    assert rc == 0
    assert head["card"] is None and head["reads"] == 4096
    arrs = fastq_native.load_file(fq, want_quals=False)
    packed = fastq_native.pack_2bit(arrs.codes, 2)
    want, claimed, B = _jax_flushes(packed, arrs.lengths, arrs.maxlen, kw)
    assert rec["variant"] == variant and rec["config"] == kw
    assert rec["stats"] == want and rec["claimed"] == claimed
    assert (rec["B"], rec["Np"], rec["SC"], rec["M"], rec["C"]) == (
        B, 4096, kw.get("shift_chunk", 16), 16, 2)
    assert 0 < claimed < 4096
    assert rec["capture_s"] is None and rec["graph_pool_bytes"] is None
    assert len(rec["flush_s"]) == 2 and rec["ms_a_round"] > 0
    assert rec["rounds"] > 0 and rec["rounds_run"] >= rec["rounds"]
    assert rec["program_cache"] == "miss"
    assert rec["ms_per_graphed_round"] is None


def test_sweep_lines_equal_compress(fq, tmp_path, capsys, monkeypatch):
    """Two configs, two passes each: every line's archive is byte-equal to
    api.compress with its engine dict on the CPU and round-trips, pass 1
    hits the program cache; the summary holds both. The consensus
    dictionaries are cut to 2^14-base segments for time, on both sides."""
    from spring_tpu_torch import api
    from spring_tpu_torch.encode import second_chance
    monkeypatch.setattr(second_chance, "SEG_BASES", 1 << 14)
    rc = sweep.main([fq, "base=", "fn4=far_near:4", "--device", "cpu",
                     "--passes", "2", "--threads", "2",
                     "--work", str(tmp_path / "w")])
    head, *recs, summary = _lines(capsys.readouterr().out)
    assert rc == 0 and summary["ok"] and summary["failures"] == []
    assert head["card"] is None and head["passes"] == 2
    assert [(r["config"], r["engine"]) for r in recs] == [
        ("base", {}), ("fn4", {"far_near": 4})]
    for r in recs:
        ref = str(tmp_path / f"{r['config']}.stpu")
        api.compress([fq], ref, api.CompressOptions(
            num_threads=2, verbose=False, engine=r["engine"]),
            device="cpu")
        with open(ref, "rb") as f:
            assert r["archive_sha256"] == hashlib.sha256(
                f.read()).hexdigest()
        assert r["archive_bytes"] == os.path.getsize(ref)
        assert r["round_trip"] == "byte-exact" and r["ok"]
        assert [p["program_cache"] for p in r["passes"]] == ["miss", "hit"]
        assert r["best_s"] == r["passes"][1]["s"]
        assert r["run"]["program_cache"] == "hit"
        assert r["run"]["rounds"] == r["passes"][1]["rounds"] > 0
        assert "reorder_run" in r["stage_s"]
    assert recs[0]["archive_sha256"] != recs[1]["archive_sha256"]
    assert [s["config"] for s in summary["summary"]] == ["base", "fn4"]
    assert summary["drift"] is None and summary["default_check"] is None
    assert os.listdir(tmp_path / "w") == []


def test_arguments_refused_and_no_card(tmp_path, capsys):
    """A JAX variable name is refused with the port's key, an unknown key
    with the known ones; with --device cuda and no card neither tool runs
    (one subprocess for both: SystemExit with a message, exit status
    1)."""
    for main, arg, want in (
            (knob.main, "SPRING_TPU_SLOTS=8",
             ("SPRING_TPU_SLOTS", "key is accept_slots")),
            (knob.main, "walkers=8", ("'walkers'", "'num_walkers'")),
            (sweep.main, "sc8=SPRING_TPU_SC:8",
             ("SPRING_TPU_SC", "key is shift_chunk")),
            (sweep.main, "x=candidates:4", ("'candidates'",
                                             "'flush_rounds'"))):
        argv = (["4096", arg] if main is knob.main else ["in.fastq", arg])
        with pytest.raises(SystemExit) as e:
            main(argv + ["--device", "cpu"])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert all(w in err for w in want), err
    code = (
        "import sys; sys.path.insert(0, 'tools')\n"
        "import knob_sweep_torch as k, sweep_probe_torch as s\n"
        "for m, a in ((k.main, ['64', '--cache', sys.argv[1]]),\n"
        "             (s.main, [sys.argv[2]])):\n"
        "    try:\n"
        "        print('rc', m(a + ['--device', 'cuda']))\n"
        "    except SystemExit as e:\n"
        "        print('exit', type(e.code).__name__, e.code,\n"
        "              file=sys.stderr)\n")
    cache = tmp_path / "cache"
    fq = tmp_path / "in.fastq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    res = subprocess.run([sys.executable, "-c", code, str(cache), str(fq)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == ""
    assert res.stderr.count("no CUDA device") == 2
    assert [x for x in res.stderr.splitlines() if x.startswith("exit")] == [
        "exit str knob_sweep_torch: no CUDA device; pass --device cpu "
        "for a CPU run",
        "exit str sweep_probe_torch: no CUDA device; pass --device cpu "
        "for a CPU run"]
    assert not cache.exists()


def test_tools_import_no_jax_and_read_no_environment():
    """Neither tool imports jax or the JAX package, and neither reads or
    sets an environment variable (the JAX names are only refused)."""
    imp = re.compile(r"^\s*(import|from)\s+(jax|spring_tpu)\b")
    for tool in (knob, sweep):
        with open(tool.__file__, encoding="utf-8") as f:
            src = f.read()
        assert not [x for x in src.splitlines() if imp.match(x)]
        assert not re.search(r"os\.environ|getenv|putenv", src)
