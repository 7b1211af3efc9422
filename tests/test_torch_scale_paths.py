"""The paths that only very large inputs take, at a small size: read
dictionaries that overflow their capped tables (100M reads: the 2^25-bucket
cap drops ~73k keys a dictionary) and the engine's 1/8-octave padding
past 2^26 reads (100M reads: Np = 6 * 2^24). spring_tpu_torch (device
"cpu") against spring_tpu (JAX on CPU): archives byte-equal, dropped keys
equal, emissions equal."""
import re

import numpy as np
import pytest

pytest.importorskip("jax")

from spring_tpu import api as japi  # noqa: E402
from spring_tpu.reorder import dictionary as jdct  # noqa: E402
from spring_tpu.reorder import engine as jeng  # noqa: E402
from spring_tpu_torch import api as tapi  # noqa: E402
from spring_tpu_torch.reorder import dictionary as tdct  # noqa: E402
from spring_tpu_torch.reorder import engine as teng  # noqa: E402
from spring_tpu_torch.utils import synth  # noqa: E402
from test_torch_engine import _reads  # noqa: E402

_DROPPED = re.compile(r"\[dict\] (\d+) keys overflowed")


def _opts():
    return japi.CompressOptions(num_threads=2, verbose=False)


def _same_archives(tmp_path, fq):
    a_jax, a_torch = str(tmp_path / "jax.stpu"), str(tmp_path / "torch.stpu")
    japi.compress([fq], a_jax, _opts())
    tapi.compress([fq], a_torch, _opts(), device="cpu")
    with open(a_jax, "rb") as f1, open(a_torch, "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("n", [
    1, 64, 1 << 20, (1 << 26) - 1, 1 << 26, (1 << 26) + 1,
    5 << 24, (5 << 24) + 1, 99_999_999, 100_000_000, 100_663_296,
    100_663_297, (1 << 27) - 1, 1 << 27, (1 << 27) + 1, 300_000_000,
    (1 << 31) - 2])
def test_padded_n_equal(n):
    assert teng.padded_n(n) == jeng.padded_n(n)


def test_padded_n_granules_sweep():
    """Every n in a sweep across 2^26 and 2^27 pads alike in both
    packages, to a multiple of 64, by less than one granule, and past
    2^26 to a granule that is not a power of two where n is not near
    one (100M reads: 6 * 2^24)."""
    rng = np.random.default_rng(3)
    ns = np.concatenate([
        rng.integers(1 << 25, 1 << 28, 2000),
        (1 << 26) + np.arange(-300, 300), (1 << 27) + np.arange(-300, 300)])
    for n in ns.tolist():
        p = teng.padded_n(n)
        assert p == jeng.padded_n(n)
        assert p >= n and p % 64 == 0
        if n > 1 << 26:
            gran = 1 << ((n - 1).bit_length() - 3)
            assert p - n < gran and p % gran == 0
    assert teng.padded_n(100_000_000) == 6 << 24


@pytest.fixture
def granules(monkeypatch):
    """Both engines pad past 1,024 reads in 1/8-octave granules: the
    port's threshold lowered, and the JAX engine given the port's
    padded_n (its own threshold is a literal)."""
    monkeypatch.setattr(teng, "POW2_MAX_READS", 1024)
    monkeypatch.setattr(jeng, "padded_n", teng.padded_n)


def test_engine_at_granule_np(granules):
    packed, lengths = _reads(3000, seed=11)
    j_em = jeng.ReorderEngine(packed, lengths,
                              jeng.ReorderConfig(max_readlen=100)).run()
    t_em = teng.ReorderEngine(packed, lengths,
                              teng.ReorderConfig(max_readlen=100),
                              device="cpu").run()
    assert teng.LAST_RUN_STATS["Np"] == 3072      # 6 granules of 512
    assert len(j_em) > 1500
    np.testing.assert_array_equal(t_em, j_em)
    assert teng.LAST_RUN_STATS["rounds"] == jeng.LAST_RUN_STATS["rounds"]


def test_granule_archive_equal(tmp_path, granules):
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 5000, read_len=100, genome_size=12_500, seed=21,
                  n_rate=0.0005)
    _same_archives(tmp_path, fq)
    assert teng.LAST_RUN_STATS["Np"] == 5120      # 5 granules of 1024


def test_dropped_keys_archive_equal(tmp_path, monkeypatch, capsys):
    """The read dictionaries' tables capped at 1,024 buckets (8,192
    slots for 16,384 reads) in both packages, so that each drops keys;
    the consensus dictionary (2^24 positions and up) keeps its size, as
    at 100M reads, where only the read tables reach the cap."""
    def capped(orig):
        def table_buckets(n_keys):
            b = orig(n_keys)
            return min(b, 1024) if n_keys < 1 << 20 else b
        return table_buckets

    monkeypatch.setattr(jdct, "table_buckets", capped(jdct.table_buckets))
    monkeypatch.setattr(tdct, "table_buckets", capped(tdct.table_buckets))
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 16_384, read_len=100, genome_size=40_000, seed=22,
                  n_rate=0.0005)
    capsys.readouterr()
    _same_archives(tmp_path, fq)
    said = [int(k) for k in _DROPPED.findall(capsys.readouterr().err)]
    got = teng.LAST_RUN_STATS["dict_dropped"]
    assert len(got) == 2 and min(got) > 0
    assert said == got + got        # the JAX engine's report, then ours
