"""Fixtures of the benchmark's own tests, which all run on the CPU (run
them with ``python -m pytest benchmark/tests -q`` from the checkout's
root)."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"pairs": 600, "genome_size": 20000}


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with a tiny traffic mix,
    ``tiny``, and a cell ``<config>.tiny`` of every configuration on it:
    data files only, as a later change would add them."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    with open(root / "benchmark" / "traffic" / "deep.json") as f:
        traffic = json.load(f)
    traffic.update(TINY)
    with open(root / "benchmark" / "traffic" / "tiny.json", "w") as f:
        json.dump(traffic, f)
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["workloads"] += [
        {"name": f"{c['name']}.tiny", "config": c["name"],
         "traffic": "tiny", "chips": 1, "why": "a test's tiny cell"}
        for c in spec["configs"]]
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    return str(root)
