"""Finding a cell's files by name.

BENCHMARK.json (at the checkout's root) names each cell's configuration,
traffic and metrics. A configuration is the JSON file its entry names; a
traffic mix is ``benchmark/traffic/<traffic>.json``; a metric is
``benchmark/metrics/<metric>.py``, a module with ``read(run)`` that
returns the metric's value, or None where the run has nothing to read.
Adding any of them takes new files and entries, and no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
DIR = os.path.basename(BENCH)      # the benchmark's folder in a checkout


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, workload: str, root: str = ROOT) -> dict:
    """The workload's entry with its configuration and traffic loaded:
    keys ``workload``, ``config``, ``traffic``, ``end_to_end`` and
    ``per_layer`` (every cell reports every metric that its run has
    something to read for)."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, DIR, "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)

    return dict(workload=w, config=config, traffic=traffic,
                end_to_end=spec["end_to_end"], per_layer=spec["per_layer"])


def reader(name: str, root: str = ROOT):
    """The metric's module, ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, DIR, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
