"""tools/bench_dist_torch.py, the port's counterpart of tools/bench_dist.py,
on the CPU (gloo): ``chip`` mode at 4,096 reads (both engines, three
passes each, the JSON line's fields, both round trips), a forced
round-trip mismatch that must exit non-zero, ``ranks 2``, the refusal of
two ranks on one card, and the made input (bench.py's profile)."""
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch
import torch.distributed as tdistributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "bench_dist_torch.py")
ENV = dict(os.environ, OMP_NUM_THREADS="2")

spec = importlib.util.spec_from_file_location("bench_dist_torch", TOOL)
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    """4,096 reads of 100 bases at ~50x of an 8,000-base genome: enough
    contigs that both engines run some rounds, few enough that a
    compress takes seconds here."""
    from spring_tpu_torch.utils import synth
    path = str(tmp_path_factory.mktemp("bd") / "in.fastq")
    synth.make_se(path, 4096, read_len=100, genome_size=8000, seed=7)
    return path


def _last_line(text):
    return json.loads(text.strip().splitlines()[-1])


def test_chip_mode_on_the_cpu(fq, tmp_path, capsys):
    from spring_tpu_torch.parallel import dist as tdist
    from spring_tpu_torch.parallel import multihost as tmh
    from spring_tpu_torch.reorder import dictionary as tdct
    out = tmp_path / "rec.jsonl"
    rc = tool.main(["chip", fq, "--device", "cpu", "--threads", "2",
                    "--work", str(tmp_path / "w"), "--out", str(out)])
    rec = _last_line(capsys.readouterr().out)
    assert rc == 0, rec["failures"]
    assert rec["ok"] and rec["failures"] == []
    assert rec["mode"] == "chip" and rec["reads"] == 4096
    assert rec["card"] is None and rec["kind"] is None
    assert not tdistributed.is_initialized()
    for label in ("default", "dist"):
        e = rec[label]
        assert e["roundtrip_ok"] is True and e["archive_bytes"] > 0
        assert e["rounds"] > 0 and e["rounds_run"] >= e["rounds"]
        assert 0 <= e["unmatched_frac"] < 0.05
        assert (e["Np"], e["B"]) == (4096, 16)
        assert [p["program_cache"] for p in e["passes"]] \
            == ["miss", "hit", "hit"]
        assert e["best_s"] == min(p["compress_s"] for p in e["passes"][1:])
        assert "reorder_run" in e["stage_s"]
        for p in e["passes"]:
            assert p["peak_allocated"] is None
            assert p["stage_peak_bytes"] == {}          # no card here
        assert e["launches"] == {"verify_rows": 0,      # CPU: plain versions
                                 "masked_hamming_rows": 0}
    assert len(rec["default"]["dict_dropped"]) == 2     # a window each
    d = rec["dist"]
    assert len(d["dict_dropped"]) == 1                  # a rank each
    assert d["world_size"] == 1 and d["collectives_per_round"] == 7
    assert d["collectives"] > 0 and d["world_collective_s"] > 0
    world = tmh.World(None, 0, 1, torch.device("cpu"))
    starts = tuple(w.start for w in tdct.default_windows(100))
    cfg = tdist.DistConfig(max_readlen=100)
    prog = tdist._dist_programs(
        world, 4096, 7, 16, cfg.candidates, cfg.shift_chunk,
        cfg.accept_slots, starts, cfg.thresh, cfg.capacity_factor)
    assert d["exchange"] == prog["exchange"]
    assert rec["dist_over_default"] == round(
        d["best_s"] / rec["default"]["best_s"], 4)
    s = rec["default"]["archive_bytes"]
    assert abs(d["archive_bytes"] - s) <= 0.05 * s + 10240
    with open(out) as f:
        assert json.loads(f.read().splitlines()[-1]) == rec
    # the archives and decompressed reads are removed
    assert set(os.listdir(tmp_path / "w")) <= {"store"}


def test_chip_mode_fails_on_a_round_trip_mismatch(fq, tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(tool, "same_file", lambda a, b: False)
    rc = tool.main(["chip", fq, "--device", "cpu", "--threads", "2",
                    "--work", str(tmp_path)])
    rec = _last_line(capsys.readouterr().out)
    assert rc == 1
    assert not rec["ok"]
    assert rec["failures"] == ["default: the round trip differs from the "
                               "input"]
    assert "dist" not in rec
    assert not tdistributed.is_initialized()


def test_ranks_mode_on_the_cpu(fq, tmp_path):
    res = subprocess.run(
        [sys.executable, TOOL, "ranks", "2", fq, "--device", "cpu",
         "--threads", "2", "--work", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=ENV)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = _last_line(res.stdout)
    assert rec["ok"] and rec["ranks"] == 2
    assert rec["emissions_equal"] and rec["roundtrip_ok"]
    assert rec["archive_bytes"] > 0
    assert len(rec["per_rank"]) == 2
    for r in rec["per_rank"]:
        assert len(r["seconds"]) == 3 and r["ru_maxrss_kb"] > 0
        assert r["world_size"] == 2 and r["collectives_per_round"] == 7
        assert [p["program_cache"] for p in r["passes"]] \
            == ["miss", "hit", "hit"]
    assert len({r["emissions_sha256"] for r in rec["per_rank"]}) == 1


def test_ranks_refuses_two_ranks_on_one_card(fq, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="one rank a card"):
        tool.ranks(2, fq, str(tmp_path), 2, "cuda", True)


def test_no_card_exits_without_a_result():
    env = dict(ENV, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, TOOL, "chip", "--reads", "64"],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_made_input_is_bench_profile(tmp_path):
    from spring_tpu_torch.utils import synth
    path, gen_s = tool.input_path(None, 64, str(tmp_path / "cache"))
    assert gen_s is not None
    want = tmp_path / "want.fastq"
    synth.make_se(str(want), 64, read_len=100, genome_size=2_000_000,
                  seed=42)
    with open(path, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert tool.input_path(None, 64, str(tmp_path / "cache")) == (path, None)


def test_tool_imports_nothing_of_jax():
    imp = re.compile(r"^\s*(from|import)\s+(jax|spring_tpu)(\.|\s|$)")
    with open(TOOL, encoding="utf-8") as f:
        src = f.read()
    bad = [line for line in src.splitlines()
           if imp.match(line) or "SPRING_TPU_" in line.split("#", 1)[0]]
    assert not bad, bad


def test_ranks_mode_one_pass_on_the_cpu(fq, tmp_path):
    """``ranks 2 --passes 1``, the 100M run's form: a program-cache miss
    a rank, the host RSS by stage and its progress file a rank."""
    out = tmp_path / "rec.jsonl"
    res = subprocess.run(
        [sys.executable, TOOL, "ranks", "2", fq, "--device", "cpu",
         "--threads", "2", "--passes", "1",
         "--work", str(tmp_path / "w"), "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=ENV)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = _last_line(res.stdout)
    assert rec["ok"] and rec["failures"] == []
    assert (rec["ranks"], rec["passes"], rec["threads"]) == (2, 1, 2)
    assert rec["emissions_equal"] and rec["roundtrip_ok"]
    assert rec["compare"] == "cmp" and rec["decompress_s"] > 0
    assert rec["input_bytes"] == os.path.getsize(fq) and rec["seed"] is None
    assert "Filesystem" in res.stderr and "Mem:" in res.stderr  # df, free
    for r, pr in enumerate(rec["per_rank"]):
        assert len(pr["seconds"]) == 1
        assert pr["best_s"] == pr["seconds"][0]
        assert [p["program_cache"] for p in pr["passes"]] == ["miss"]
        assert (pr["B"], pr["Bl"], pr["world_size"]) == (16, 8, 2)
        assert set(pr["exchange"]) == {"capk", "capq", "capc", "capr", "R",
                                       "S"}
        host = pr["passes"][0]["host_rss_gb_by_stage"]
        assert host and all(v > 0 for v in host.values())
        with open(f"{out}.rank{r}.progress") as f:
            assert json.load(f)["passes"] == [host]
    assert rec["best_s"] == max(pr["best_s"] for pr in rec["per_rank"])
    assert set(os.listdir(tmp_path / "w")) == set()


def _no_room(monkeypatch):
    """The work directory's file system without room for an output
    beside the input, and 4 KiB chunks."""
    free = tool.shutil.disk_usage

    def usage(path):
        return free(path)._replace(free=0)

    monkeypatch.setattr(tool.shutil, "disk_usage", usage)
    monkeypatch.setattr(sys.modules["rss_check_torch"], "CHUNK", 4096)


def _flip(path, at):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 1]))


@pytest.mark.parametrize("made,flip", [(False, None), (True, None),
                                       (False, 3 * 4096 + 17)])
def test_chunked_round_trip(fq, tmp_path, monkeypatch, made, flip):
    """Without room for the output the round trip compares SHA-256 sums
    of chunks: equal output passes, one flipped byte past the first chunk
    fails, and a made input is deleted before the output is written."""
    from spring_tpu_torch import api
    _no_room(monkeypatch)
    src = tmp_path / "in.fastq"
    src.write_bytes(open(fq, "rb").read())

    def decompress(arc, outs, **kw):
        assert src.exists() != made
        with open(fq, "rb") as a, open(outs[0], "wb") as b:
            b.write(a.read())
        if flip is not None:
            _flip(outs[0], flip)

    monkeypatch.setattr(api, "decompress", decompress)
    rt = tool.round_trip(str(src), "unused.stpu", str(tmp_path), 1, made)
    assert rt["compare"] == "sha256"
    assert rt["roundtrip_ok"] is (flip is None)
    assert os.listdir(tmp_path) == ([] if made else ["in.fastq"])


def test_chunked_round_trip_mismatch_exits_non_zero(fq, tmp_path, capsys,
                                                    monkeypatch):
    """A real decompress, one byte flipped past the first chunk of its
    output: the chunk comparison sees it and the run exits 1."""
    from spring_tpu_torch import api
    _no_room(monkeypatch)
    real = api.decompress

    def corrupt(arc, outs, **kw):
        real(arc, outs, **kw)
        _flip(outs[0], 3 * 4096 + 17)

    monkeypatch.setattr(api, "decompress", corrupt)
    rc = tool.main(["chip", fq, "--device", "cpu", "--threads", "2",
                    "--passes", "1", "--work", str(tmp_path)])
    rec = _last_line(capsys.readouterr().out)
    assert rc == 1 and not rec["ok"]
    assert rec["failures"] == ["default: the round trip differs from the "
                               "input"]
    assert not tdistributed.is_initialized()


def test_threads_default_to_the_cores_over_the_ranks(fq, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 32)
    assert tool.default_threads("ranks", 4) == 8
    assert tool.default_threads("ranks", 64) == 1
    assert tool.default_threads("chip", 1) == 32
    seen = {}

    def ranks(n, fq_, work, threads, *a):
        seen["threads"] = threads
        return dict(per_rank=[]), []

    monkeypatch.setattr(tool, "ranks", ranks)
    assert tool.main(["ranks", "4", fq, "--device", "cpu",
                      "--work", str(tmp_path)]) == 0
    assert seen["threads"] == 8


def test_fast_synth_writes_make_se_bytes(tmp_path, monkeypatch):
    """synth.make_se_fast, the tool's input maker, against make_se: the
    JAX package's at the 2M-read chunk, the port's own over many small
    chunks (across id widths 1-5 digits and chunk ends)."""
    from spring_tpu.utils import synth as jsynth
    from spring_tpu_torch.utils import synth as tsynth

    def same(n, seed, genome, workers):
        a, b = tmp_path / "a.fq", tmp_path / "b.fq"
        tsynth.make_se_fast(str(a), n, genome_size=genome, seed=seed,
                            workers=workers)
        (jsynth if tsynth.CHUNK_READS == 2_000_000 else tsynth).make_se(
            str(b), n, genome_size=genome, seed=seed)
        assert a.read_bytes() == b.read_bytes()

    same(12_345, 5, 2_000_000, 3)
    monkeypatch.setattr(tsynth, "CHUNK_READS", 999)
    same(10_123, 42, 9000, 4)
    same(1, 3, 500, 1)
