"""The check against the timed path broken underneath, and against the
control: each must come out as not correct. One chip, so no exchange
between chips to leave out."""
import json

import numpy as np
import pytest

import run
from harness import cell, spec

SEED = 2**31 + 99
CELLS = ("srr554369_pe_lossless.tiny", "srr554369_pe_reorder_noids.tiny")


def _unchanged(monkeypatch):
    """The compress step returns at once: the archive holds nothing of
    the input."""
    from spring_tpu_torch.pipeline import short_mode
    monkeypatch.setattr(short_mode, "compress_short",
                        lambda *a, **k: None)


def _half(monkeypatch):
    """Half of the batch left out: the step sees the first half of each
    file's records."""
    from spring_tpu_torch.pipeline import short_mode
    real = short_mode.compress_short

    def half(files, *a, **k):
        halves = []
        for f in files:
            lines = open(f, "rb").read().split(b"\n")[:-1]
            keep = len(lines) // 8 * 4
            halves.append(f + ".half")
            open(halves[-1], "wb").write(b"\n".join(lines[:keep]) + b"\n")
        return real(halves, *a, **k)

    monkeypatch.setattr(short_mode, "compress_short", half)


def _token(monkeypatch):
    """A token altered where it is produced: the first quality of every
    block the quality codec takes."""
    from spring_tpu_torch.codecs import qv
    real = qv.compress_rows

    def altered(mat, *a, **k):
        mat = np.array(mat, dtype=np.uint8)
        mat[0, 0] ^= 1
        return real(mat, *a, **k)

    monkeypatch.setattr(qv, "compress_rows", altered)


def _line(tiny_root, capsys, workload) -> dict:
    args = run.parse(["--workload", workload, "--seed", str(SEED),
                      "--seconds", "0.1", "--trace", "0"])
    assert run.report(args, "cpu", tiny_root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _token])
def test_a_fault_makes_the_run_incorrect(tiny_root, capsys, monkeypatch,
                                         workload, fault):
    fault(monkeypatch)
    line = _line(tiny_root, capsys, workload)
    assert line["correct"] is False
    assert line["failed"] == line["attempted"] >= 1
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny_root, workload):
    """The configuration's control (its lossy-quality flag) in the
    program's place fails the check by its qualities."""
    config = spec.cell(spec.load(tiny_root), workload, tiny_root)["config"]
    _, checks, outcome = cell.run(workload, SEED, 0.1, False, device="cpu",
                                  root=tiny_root, override=config["control"])
    assert outcome["correct"] is False
    assert checks.get("qual_wrong", checks["records_missing"])[0] > 0
    assert checks.get("seq_wrong", (0,))[0] == 0
