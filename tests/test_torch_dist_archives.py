"""Whole archives through the distributed reorder engine: the port with
``dist`` (gloo on the CPU, ranks spawned by multihost.launch) against
spring_tpu with SPRING_TPU_DIST=1 on a virtual CPU mesh of the same size
(spring_tpu.parallel.dist.make_mesh is patched to that size; the package
is not edited). Archives are byte-equal, or where the comparison is with
the port's single engine, within the stated tolerance."""
import filecmp
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import test_torch_dist_ranks as ranks  # noqa: E402
from spring_tpu import api as japi  # noqa: E402
from spring_tpu.parallel import dist as jdist  # noqa: E402
from spring_tpu_torch import api as tapi  # noqa: E402
from spring_tpu_torch import cli as tcli  # noqa: E402
from spring_tpu_torch.parallel import multihost as tmh  # noqa: E402
from spring_tpu_torch.reorder import engine as teng  # noqa: E402
from spring_tpu_torch.utils import synth  # noqa: E402

TIMEOUT = 240.0      # of one launch: the group's collectives and the wait


def launch(fn, n, *args):
    return tmh.launch(fn, n, args, device="cpu", timeout=TIMEOUT,
                      num_threads=1)


def _mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jdist.make_mesh(n)


@pytest.fixture(scope="module")
def fastq_2k(tmp_path_factory):
    """The 2,000 reads of 100 bases of tests/test_dist.py."""
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, size=20000)
    L, n = 100, 2000
    starts = rng.integers(0, len(genome) - L, size=n)
    fq = tmp_path_factory.mktemp("dist") / "d.fastq"
    with open(fq, "wb") as f:
        for i, s in enumerate(starts):
            seg = bytes(b"ACGT"[c] for c in genome[s:s + L])
            f.write(b"@d%d\n%s\n+\n%s\n" % (i, seg, b"E" * L))
    return str(fq)


@pytest.mark.parametrize("n", [1, 2])
def test_archives_byte_equal_and_cross_readable(tmp_path, monkeypatch,
                                                fastq_2k, n):
    """The port with dist at world size n against spring_tpu with
    SPRING_TPU_DIST=1 on a mesh of n: byte-equal archives, and each
    package decompresses the other's to the input."""
    mesh = _mesh(n)
    monkeypatch.setattr(jdist, "make_mesh", lambda *a, **k: mesh)
    monkeypatch.setenv("SPRING_TPU_DIST", "1")
    j_arc = str(tmp_path / "jax.stpu")
    japi.compress([fastq_2k], j_arc,
                  japi.CompressOptions(num_threads=2, verbose=False))
    t_arc = str(tmp_path / "torch.stpu")
    if n == 1:
        # one rank, no launcher: the command line's own path
        assert tcli.main(["-c", "-i", fastq_2k, "-o", t_arc, "--dist",
                          "--device", "cpu", "-t", "2", "--quiet"]) == 0
        assert teng.LAST_RUN_STATS["world_size"] == 1
    else:
        stats = launch(ranks.compress, n, [fastq_2k], t_arc, 2)
        assert [s["world_size"] for s in stats] == [n] * n
        assert "unmatched_frac" in stats[0]       # rank 0 went on
        assert "unmatched_frac" not in stats[1]   # the others returned
    assert filecmp.cmp(j_arc, t_arc, shallow=False)
    out = str(tmp_path / "a.fastq")
    japi.decompress(t_arc, [out], verbose=False, num_threads=2)
    assert filecmp.cmp(fastq_2k, out, shallow=False)
    out = str(tmp_path / "b.fastq")
    tapi.decompress(j_arc, [out], verbose=False, num_threads=2)
    assert filecmp.cmp(fastq_2k, out, shallow=False)


def test_super_shards_at_two_ranks(tmp_path, monkeypatch):
    """With the read cap lowered to 8,192, 8,329 reads become two shards
    (8,192 and 137 reads): every rank loops over the same shards, rank 0
    writes them, and the archive is spring_tpu's on a mesh of two."""
    from spring_tpu_torch.io.container import ArchiveReader
    cap, n = 8192, 8192 + 137
    fq = str(tmp_path / "s.fastq")
    synth.make_se(fq, n_reads=n, read_len=100, genome_size=30_000, seed=31)
    mesh = _mesh(2)
    monkeypatch.setattr(jdist, "make_mesh", lambda *a, **k: mesh)
    monkeypatch.setenv("SPRING_TPU_DIST", "1")
    monkeypatch.setenv("SPRING_TPU_SHARD_READS", str(cap))
    j_arc = str(tmp_path / "jax.stpu")
    japi.compress([fq], j_arc,
                  japi.CompressOptions(num_threads=2, verbose=False))
    t_arc = str(tmp_path / "torch.stpu")
    launch(ranks.compress, 2, [fq], t_arc, 2, cap)
    assert filecmp.cmp(j_arc, t_arc, shallow=False)
    with ArchiveReader(t_arc) as r:
        assert tuple(r.params.shard_reads) == (cap, n - cap)
    out = str(tmp_path / "s.out")
    tapi.decompress(t_arc, [out], verbose=False, num_threads=2)
    assert filecmp.cmp(fq, out, shallow=False)


def test_dist_archive_size_parity_with_single_engine(tmp_path):
    """The archive-size test of tests/test_dist.py for the port, at
    20,000 reads over a 400,000-base genome (the same 5x coverage; the
    size a CPU run of the eager round can afford): world size 2 against
    the port's single-device engine, within 5% + 10,240 bytes."""
    fq = str(tmp_path / "p.fastq")
    synth.make_se(fq, n_reads=20_000, read_len=100, genome_size=400_000,
                  seed=17)
    single = str(tmp_path / "single.stpu")
    tapi.compress([fq], single,
                  tapi.CompressOptions(num_threads=2, verbose=False),
                  device="cpu")
    dist = str(tmp_path / "dist.stpu")
    launch(ranks.compress, 2, [fq], dist, 2)
    s1, s2 = os.path.getsize(single), os.path.getsize(dist)
    assert abs(s2 - s1) <= 0.05 * s1 + 10240, (s1, s2)
    out = str(tmp_path / "p.out")
    tapi.decompress(dist, [out], verbose=False, num_threads=2)
    assert filecmp.cmp(fq, out, shallow=False)
