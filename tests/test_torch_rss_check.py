"""tools/rss_check_torch.py, the port's scale check, on the CPU: at 20,000
reads it makes its input in the cache directory, compresses and
decompresses it in child processes and reports one JSON line; a compress
that fails gives a non-zero exit with the error in that line. The same
for tools/build_peak_torch.py at 5,000 reads. Neither tool imports
anything of JAX or of the JAX package."""
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "rss_check_torch.py")
PEAK = os.path.join(REPO, "tools", "build_peak_torch.py")


# the tools' processes run beside the other test workers: two threads each
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def _run(tmp_path, *args):
    res = subprocess.run(
        [sys.executable, TOOL, *args, "--device", "cpu", "--threads", "2",
         "--cache", str(tmp_path / "cache"), "--work", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=ENV)
    return res, json.loads(res.stdout.strip().splitlines()[-1])


def test_rss_check_round_trip_on_cpu(tmp_path):
    res, rec = _run(tmp_path, "20000", "100", "64",
                    "--out", str(tmp_path / "rec.jsonl"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert rec["ok"] and rec["round_trip"] and rec["compare"] == "cmp"
    assert rec["n_reads"] == 20000 and rec["genome_size"] == 2_000_000
    assert rec["seed"] == 5 and rec["device"] == "cpu"
    assert rec["card"] is None
    assert rec["input_bytes"] == os.path.getsize(
        tmp_path / "cache" / "in_20000_100.fastq")
    assert rec["archive_bytes"] > 0 and rec["gen_s"] is not None
    assert rec["compress_s"] > 0 and rec["decompress_s"] > 0
    assert rec["compress_ru_maxrss_gb"] > 0 and rec["rss_within_limit"]
    stages = rec["LAST_STAGE_SECONDS"]
    assert {"load+parse", "reorder_run", "second_chance"} <= set(stages)
    assert rec["LAST_STAGE_PEAK_BYTES"] == {}       # no card here
    assert rec["rounds"] > 0 and rec["rounds_run"] >= rec["rounds"]
    assert rec["unmatched_reads"] == round(rec["unmatched_frac"] * 20000)
    assert rec["Np"] == 32768 and rec["B"] == 128
    assert len(rec["dict_dropped"]) == 2
    assert rec["consensus_segments"] == {"stitch_match": 1,
                                         "second_chance_match": 1}
    assert rec["verify_rows_launches"] == 0         # CPU: plain version
    assert set(rec["compress_sampled_by_stage"]) <= set(stages) | {
        "after codec+write"}
    with open(tmp_path / "rec.jsonl") as f:
        assert json.loads(f.read().splitlines()[-1]) == rec
    # the input stays in the cache; the work directory is emptied
    assert os.listdir(tmp_path / "cache") == ["in_20000_100.fastq"]
    assert [p for p in os.listdir(tmp_path)
            if p.startswith("rss_check_torch_")] == []


def test_rss_check_fails_loudly(tmp_path):
    """Reads past the short mode's 511 bases make the compress raise: the
    exit code is 1, the JSON line holds the error and no round trip. A
    second run takes the cached input and holds the child's peak RSS to
    its limit."""
    res, rec = _run(tmp_path, "200", "600", "64")
    assert res.returncode == 1 and rec["gen_s"] is not None
    assert not rec["ok"] and not rec["round_trip"]
    assert "use long mode" in rec["error"][0]
    assert rec["archive_bytes"] is None and rec["rss_within_limit"]
    res, rec = _run(tmp_path, "200", "600", "0.001")
    assert res.returncode == 1 and rec["gen_s"] is None
    assert not rec["rss_within_limit"]


def test_build_peak_on_cpu():
    res = subprocess.run([sys.executable, PEAK, "--device", "cpu",
                          "--reads", "5000"], capture_output=True,
                         text=True, timeout=600, env=ENV)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["Np"] == 8192 and rec["buckets"] == 4096
    for k in ("read_dict", "read_dict_wide", "consensus_segment"):
        assert rec[k]["peak_over_input_bytes"] is None     # no card
        assert len(rec[k]["sha256"]) == 64 and rec[k]["seconds"] >= 0
    assert rec["read_dict"]["sha256"] != rec["read_dict_wide"]["sha256"]


def test_build_peak_dist_on_cpu():
    """--dist-ranks: rank 0's distributed build at the engine's Np (the
    power of two at or above --reads) over a world of that size."""
    res = subprocess.run([sys.executable, PEAK, "--device", "cpu",
                          "--reads", "5000", "--dist-ranks", "4"],
                         capture_output=True, text=True, timeout=600, env=ENV)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert (rec["Np"], rec["ranks"], rec["walkers"]) == (8192, 4, 32)
    assert rec["exchange"]["R"] == 4 * rec["exchange"]["capk"]
    assert "read_dict" not in rec
    assert rec["dist_build"]["peak_over_input_bytes"] is None
    assert len(rec["dist_build"]["sha256"]) == 64


@pytest.mark.parametrize("tool", [TOOL, PEAK])
def test_tools_import_nothing_of_jax(tool):
    imp = re.compile(r"^\s*(from|import)\s+(jax|spring_tpu)(\.|\s|$)")
    with open(tool, encoding="utf-8") as f:
        src = f.read()
    bad = [line for line in src.splitlines()
           if imp.match(line) or "SPRING_TPU_" in line.split("#", 1)[0]]
    assert not bad, bad
    assert "spring_tpu_torch" in src
