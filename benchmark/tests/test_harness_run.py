"""A tiny cell end to end on the CPU, the metric files, and the data-
driven lookup of a new traffic mix."""
import json
import os

import pytest

import run
from harness import cell, spec, synth

SEED = 2**31 + 4321      # larger than 32 signed bits hold


def _last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("workload,trace", [
    ("srr554369_pe_lossless.tiny", 0),
    ("srr554369_pe_reorder_noids.tiny", 1)])
def test_tiny_cell_prints_the_contract_line(tiny_root, capsys, workload,
                                            trace):
    args = run.parse(["--workload", workload, "--seed", str(SEED),
                      "--seconds", "0.1", "--trace", str(trace)])
    assert run.report(args, "cpu", tiny_root) == 0
    line = _last_line(capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in line["checks"].values())
    entry = spec.cell(spec.load(tiny_root), workload, tiny_root)
    names = {m["name"] for m in entry["per_layer" if trace else
                                      "end_to_end"]}
    # a CPU run has no device peak and no device spans to read
    cpu_silent = {"peak_device_gb", "device.idle_pct",
                  "device.reserved_growth_gb",
                  "verify_rows_roofline"}
    assert set(line["metrics"]) == names - cpu_silent
    for m in line["metrics"].values():
        assert m["value"] > 0 or m["unit"] == "%"
    assert line["device"]["platform"] == "cpu"
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0


def test_every_metric_file_loads_by_name():
    s = spec.load()
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(spec.reader(m["name"]).read), m["name"]


def test_a_new_traffic_file_is_found_with_no_edit(tiny_root, tmp_path):
    traffic = dict(json.load(open(os.path.join(
        tiny_root, "benchmark", "traffic", "tiny.json"))),
        pairs=50, genome_size=5000, qual_levels=8)
    with open(os.path.join(tiny_root, "benchmark", "traffic",
                           "throwaway.json"), "w") as f:
        json.dump(traffic, f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    s = json.load(open(path))
    s["workloads"].append({"name": "srr554369_pe_lossless.throwaway",
                           "config": "srr554369_pe_lossless",
                           "traffic": "throwaway", "chips": 1, "why": "t"})
    json.dump(s, open(path, "w"))
    entry = spec.cell(spec.load(tiny_root), "srr554369_pe_lossless.throwaway",
                      tiny_root)
    assert entry["traffic"]["pairs"] == 50
    files = [str(tmp_path / "a.fq"), str(tmp_path / "b.fq")]
    synth.generate(entry["traffic"], SEED, files)
    assert all(os.path.getsize(f) > 0 for f in files)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell(spec.load(), "no_such.cell")


def test_forbidden_modules_are_compared_whole(monkeypatch):
    import sys
    import types
    before = cell.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "spring_tpu_torch_x", types.ModuleType(
        "spring_tpu_torch_x"))
    assert cell.loaded_forbidden() == before
    monkeypatch.setitem(sys.modules, "spring_tpu.api",
                        types.ModuleType("spring_tpu.api"))
    assert "spring_tpu" in cell.loaded_forbidden()

