"""Wide dictionary rows on demand (ReorderConfig.force_wide, the
counterpart of the JAX package's SPRING_TPU_FORCE_WIDE): the engine's
emissions and a 16k-read compress equal spring_tpu's (JAX on the CPU)
with its FORCE_WIDE set, and an engine that differs only in force_wide
misses the program cache."""
import filecmp

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from spring_tpu import api as japi  # noqa: E402
from spring_tpu.parallel import dist as jdist  # noqa: E402
from spring_tpu.reorder import dictionary as jdct  # noqa: E402
from spring_tpu.reorder import engine as jeng  # noqa: E402
from spring_tpu_torch import api as tapi  # noqa: E402
from spring_tpu_torch.reorder import dictionary as tdct  # noqa: E402
from spring_tpu_torch.reorder import engine as teng  # noqa: E402
from spring_tpu_torch.utils import synth  # noqa: E402
from test_torch_flush_graph import _reads  # noqa: E402


@pytest.fixture
def jax_wide(monkeypatch):
    """spring_tpu with its FORCE_WIDE switch on; its program caches
    cleared around the test (the switch is trace-time state), and the
    port's."""
    def clear():
        jax.clear_caches()
        jeng._flush_program.cache_clear()
        jdist._dist_programs.cache_clear()
        tapi.clear_program_cache()
    clear()
    monkeypatch.setattr(jdct, "FORCE_WIDE", True)
    yield
    monkeypatch.setattr(jdct, "FORCE_WIDE", False)
    clear()


def _engine(packed, lengths, wide):
    e = teng.ReorderEngine(
        packed, lengths,
        teng.ReorderConfig(max_readlen=100, force_wide=wide), device="cpu")
    em = e.run()
    return e, em, dict(teng.LAST_RUN_STATS)


def test_force_wide_engine_equals_jax_and_misses_the_cache(jax_wide):
    packed, lengths = _reads(3000, seed=61, genome=12000)
    want = jeng.ReorderEngine(packed, lengths,
                              jeng.ReorderConfig(max_readlen=100)).run()
    _, compact, s0 = _engine(packed, lengths, False)
    e, got, s1 = _engine(packed, lengths, True)
    np.testing.assert_array_equal(got, want)
    assert s0["program_cache"] == "miss" and s1["program_cache"] == "miss"
    _, again, s2 = _engine(packed, lengths, True)
    np.testing.assert_array_equal(again, want)
    assert s2["program_cache"] == "hit"
    # the wide rows answer as the compact ones: the run differs only in
    # its row format, not in what it matched
    np.testing.assert_array_equal(got, compact)
    assert e._program_key != teng.ReorderEngine(
        packed, lengths, teng.ReorderConfig(max_readlen=100),
        device="cpu")._program_key
    d = teng.ReorderEngine(packed, lengths, teng.ReorderConfig(
        max_readlen=100, force_wide=True), device="cpu").dicts
    assert all(x.btab.shape[1] == tdct.WIDE_WORDS for x in d)


def test_force_wide_compress_equals_jax(tmp_path, jax_wide):
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 16_384, read_len=100, genome_size=40_000, seed=7,
                  n_rate=0.0005)
    a_jax, a_torch = str(tmp_path / "jax.stpu"), str(tmp_path / "t.stpu")
    japi.compress([fq], a_jax, japi.CompressOptions(num_threads=2,
                                                    verbose=False))
    tapi.compress([fq], a_torch, tapi.CompressOptions(
        num_threads=2, verbose=False, engine=dict(force_wide=True)),
        device="cpu")
    assert filecmp.cmp(a_jax, a_torch, shallow=False)
    assert teng.LAST_RUN_STATS["rounds"] == jeng.LAST_RUN_STATS["rounds"]
