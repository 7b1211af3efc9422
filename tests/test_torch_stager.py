"""The path of large inputs (spring_tpu_torch/pipeline/short_mode.py,
inputs of STAGER_MIN_READS reads and up): reorder/engine.py's
DeviceRowStager over full and tail segments, ReorderEngine(rows_dev=...)
against the engine without it, compress_short with the threshold lowered
against spring_tpu's archive (JAX on the CPU) byte for byte, with the
stager and without it (CompressOptions.stager), and a dictionary-build
prewarm whose failure is the compress call's."""
import filecmp

import numpy as np
import pytest

from spring_tpu_torch import api as tapi
from spring_tpu_torch.io import fastq_native
from spring_tpu_torch.pipeline import short_mode as tshort
from spring_tpu_torch.reorder import engine as teng
from spring_tpu_torch.utils import synth
from test_torch_flush_graph import _jax, _reads


@pytest.mark.parametrize("n", [1, 100, 10_000, 2_000_000, 10_000_000])
def test_stager_table_size_is_spring_tpus(n):
    _, jeng = _jax()
    seg = 1 << 19
    assert teng.DeviceRowStager(n, 7, seg, "cpu").cap \
        == jeng.DeviceRowStager(n, 7, seg).cap


def test_stager_feeds_full_and_tail_segments():
    n, W, seg = 10_000, 3, 4096
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 2**32, (n, W), dtype=np.uint64).astype(np.uint32)
    st = teng.DeviceRowStager(n, W, seg, "cpu")
    assert st.cap == 12_288
    for r0 in range(0, n, seg):
        st.feed(r0, rows[r0:r0 + seg])
    want = np.zeros((st.cap, W), np.uint32)
    want[:n] = rows
    np.testing.assert_array_equal(st.rows().numpy().view(np.uint32), want)
    # a tail fed again after garbage: the pad past it is zeros again
    st.feed(8192, np.full((seg, W), 7, np.uint32))
    st.feed(8192, rows[8192:])
    np.testing.assert_array_equal(st.rows().numpy().view(np.uint32), want)
    st.release()
    with pytest.raises(RuntimeError, match="release"):
        st.rows()
    with pytest.raises(RuntimeError, match="release"):
        st.feed(0, rows[:seg])


def test_engine_from_staged_rows_equals_engine_without():
    packed, lengths = _reads(3000, seed=81, genome=12_000)
    select = np.nonzero(np.arange(3000) % 5 != 2)[0].astype(np.int32)
    cfg = teng.ReorderConfig(max_readlen=100)
    want = teng.ReorderEngine(packed, lengths, cfg, select=select,
                              device="cpu").run()
    assert not teng.LAST_RUN_STATS["staged_rows"]
    st = teng.DeviceRowStager(3000, packed.shape[1], 1024, "cpu")
    for r0 in range(0, 3000, 1024):
        st.feed(r0, packed[r0:r0 + 1024])
    e = teng.ReorderEngine(packed, lengths, cfg, select=select,
                           device="cpu", rows_dev=st.rows())
    st.release()
    got = e.run()
    assert teng.LAST_RUN_STATS["staged_rows"]
    assert e._rows_dev is None      # dropped before the dictionary build
    np.testing.assert_array_equal(got, want)


def _small_large_path(monkeypatch):
    """The large-input path at a few thousand reads, in 4096-read
    segments."""
    monkeypatch.setattr(tshort, "STAGER_MIN_READS", 1000)
    monkeypatch.setattr(fastq_native, "_SEG_RECORDS", 4096)


def test_staged_compress_byte_equal_to_spring_tpu(tmp_path, monkeypatch):
    from spring_tpu import api as japi
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 9000, read_len=100, genome_size=22_000, seed=9,
                  n_rate=0.0005)
    a_jax, a_torch = str(tmp_path / "jax.stpu"), str(tmp_path / "t.stpu")
    opts = japi.CompressOptions(num_threads=2, verbose=False)
    japi.compress([fq], a_jax, opts)
    _small_large_path(monkeypatch)
    tapi.compress([fq], a_torch, opts, device="cpu")
    stats = teng.LAST_RUN_STATS
    assert stats["staged_rows"] and stats["dict_prewarm_s"] is not None
    assert filecmp.cmp(a_jax, a_torch, shallow=False)
    out = str(tmp_path / "out.fastq")
    tapi.decompress(a_torch, [out], verbose=False, num_threads=2)
    assert filecmp.cmp(fq, out, shallow=False)


def test_compress_without_stager_byte_equal_to_spring_tpu(tmp_path,
                                                         monkeypatch):
    """CompressOptions.stager False (spring_tpu's SPRING_TPU_NO_STAGER):
    the large-input path without staged rows, its prewarm kept, gives
    spring_tpu's archive."""
    from spring_tpu import api as japi
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 9000, read_len=100, genome_size=22_000, seed=12,
                  n_rate=0.0005)
    a_jax, a_torch = str(tmp_path / "jax.stpu"), str(tmp_path / "t.stpu")
    monkeypatch.setenv("SPRING_TPU_NO_STAGER", "1")
    japi.compress([fq], a_jax, japi.CompressOptions(num_threads=2,
                                                    verbose=False))
    _small_large_path(monkeypatch)
    tapi.compress([fq], a_torch, tapi.CompressOptions(
        num_threads=2, verbose=False, stager=False), device="cpu")
    stats = teng.LAST_RUN_STATS
    assert not stats["staged_rows"] and stats["dict_prewarm_s"] is not None
    assert filecmp.cmp(a_jax, a_torch, shallow=False)


def test_prewarm_failure_fails_the_compress(tmp_path, monkeypatch):
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 2000, read_len=100, genome_size=6000, seed=10)
    _small_large_path(monkeypatch)

    def fail(*args):
        raise ValueError("prewarm failed")

    monkeypatch.setattr(tshort, "_prewarm_dict_build", fail)
    with pytest.raises(ValueError, match="prewarm failed"):
        tapi.compress([fq], str(tmp_path / "a.stpu"),
                      tapi.CompressOptions(num_threads=2, verbose=False),
                      device="cpu")


def test_cuda_stager_equals_cpu_stager():
    """On a card the segments go through pinned buffers and a side
    stream: the table equals the CPU stager's."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stager's copies run on a side "
                    "stream only there")
    n, W, seg = 10_000, 7, 4096
    rows = np.random.default_rng(6).integers(
        0, 2**32, (n, W), dtype=np.uint64).astype(np.uint32)
    tables = []
    for dev in ("cpu", "cuda"):
        st = teng.DeviceRowStager(n, W, seg, dev)
        for r0 in range(0, n, seg):
            st.feed(r0, rows[r0:r0 + seg])
        tables.append(st.rows().cpu())
        st.release()
    assert torch.equal(*tables)
