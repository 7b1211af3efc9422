"""bench_torch.py (the port's counterpart of bench.py) at a small scale
on the CPU: one JSON line on stdout with every key of bench.py's line, a
byte-exact round trip at both scales, and null device numbers."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "reads",
              "small_scale", "stage_s", "engine", "probe")


def test_bench_torch_on_the_cpu():
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--device",
         "cpu", "--reads", "4096", "--reads-small", "2048"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    for k in BENCH_KEYS:
        assert k in line, k
    assert line["metric"] == "compress_reads_per_s"
    assert line["unit"] == "reads/s" and line["value"] > 0
    assert line["reads"] == 4096 and line["small_scale"]["reads"] == 2048
    assert line["round_trip"] == "byte-exact"
    assert line["engine"]["rounds"] > 0 and "reorder_run" in line["stage_s"]
    assert [p["program_cache"] for p in line["passes"]] \
        == ["miss", "hit", "hit"]
    assert line["peak_device_bytes"] is None and line["card"] is None
    assert line["probe"]["pre"]["sync_ms"] is None


def test_bench_torch_without_a_card_fails():
    """--device cuda where torch sees no card: an error, no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--reads",
         "64", "--reads-small", "64"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr
