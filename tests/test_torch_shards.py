"""Super-shard archives of the port against spring_tpu's, with the
per-archive read cap lowered on both sides to the smallest value the
parser's checkpoint stride allows for PE (8,192 reads): the port reads
its own params.MAX_NUM_READS_SHORT at call time, spring_tpu reads the
SPRING_TPU_SHARD_READS environment variable. Tolerance: exact (archives
and decompressed files byte-equal, each package reading the other's)."""
import filecmp

import pytest

pytest.importorskip("jax")

import test_torch_modes as modes  # noqa: E402
from spring_tpu import api as japi  # noqa: E402
from spring_tpu_torch import api as tapi  # noqa: E402
from spring_tpu_torch import params as tP  # noqa: E402
from spring_tpu_torch.io import fastq_native as tfqn  # noqa: E402
from spring_tpu_torch.io.container import ArchiveReader  # noqa: E402
from spring_tpu_torch.pipeline import short_mode as tshort  # noqa: E402

# name -> (paired, CompressOptions fields)
KINDS = {"se_reorder": (False, {"reorder": True}), "pe": (True, {})}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """name -> (plain inputs, spring_tpu archive, port archive, stage
    record of the port's run, reads per file), two shards each."""
    cap = 2 * tfqn.ckpt_stride()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tP, "MAX_NUM_READS_SHORT", cap)
        mp.setenv("SPRING_TPU_SHARD_READS", str(cap))
        for name, (paired, fields) in KINDS.items():
            d = tmp_path_factory.mktemp(name)
            # SE: shards of 8192 and 137 reads; PE: of 4096 and 37 pairs
            n = cap // 2 + 37 if paired else cap + 137
            files, plain = modes._inputs(d, paired, "fastq", n, seed=29)
            a_jax, a_torch = modes._both(d, files, fields)
            out[name] = (plain, a_jax, a_torch,
                         dict(tshort.LAST_STAGE_SECONDS), n)
    return out


def _records(path):
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [tuple(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_super_shard_archive_byte_equal(sharded, kind):
    plain, a_jax, a_torch, stages, n = sharded[kind]
    assert filecmp.cmp(a_jax, a_torch, shallow=False)
    with ArchiveReader(a_torch) as r:
        cp = r.params
        assert len(cp.shard_reads) == 2
        assert sum(cp.shard_reads) == cp.num_reads == n * len(plain)
        assert {"sh0/params.json", "sh1/params.json"} <= set(r.names())
    # a shard's compress adds to the outer call's stage record and does
    # not wipe it: the outer scan is still there after the last shard
    assert "scan" in stages and "codec+write" in stages
    assert "reorder_run" in stages


@pytest.mark.parametrize("reader", ["port_reads_jax", "jax_reads_port"])
def test_super_shard_roundtrip(sharded, tmp_path, reader):
    plain, a_jax, a_torch, _stages, _n = sharded["pe"]
    api, arc = ((tapi, a_jax) if reader == "port_reads_jax"
                else (japi, a_torch))
    outs = [str(tmp_path / "o1"), str(tmp_path / "o2")]
    api.decompress(arc, outs, verbose=False, num_threads=2)
    for p, o in zip(plain, outs):
        assert filecmp.cmp(p, o, shallow=False)


def test_super_shard_reorder_keeps_the_multiset(sharded, tmp_path):
    plain, _a_jax, a_torch, _stages, n = sharded["se_reorder"]
    o_t, o_j = str(tmp_path / "t"), str(tmp_path / "j")
    tapi.decompress(a_torch, [o_t], verbose=False, num_threads=2)
    japi.decompress(a_torch, [o_j], verbose=False, num_threads=2)
    assert filecmp.cmp(o_t, o_j, shallow=False)
    got = _records(o_t)
    assert len(got) == n and sorted(got) == sorted(_records(plain[0]))


@pytest.mark.parametrize("kind,outs,second_file", [
    ("se_reorder", 1, False), ("pe", 2, False), ("pe", 2, True),
    ("pe", 1, True)])
def test_super_shard_range_across_the_boundary(sharded, tmp_path, kind,
                                               outs, second_file):
    """A read range that straddles the shard boundary, in file 1 or in
    file 2 of the global index space: the port's decompress and
    spring_tpu's give byte-equal files, and for the order-preserving PE
    archive each output equals its file's slice of the input."""
    plain, a_jax, a_torch, _stages, n = sharded[kind]
    per_shard = 2 * tfqn.ckpt_stride() // len(plain)
    lo = per_shard - 5 + (n if second_file else 0)
    hi = lo + 14
    got = {}
    for tag, api, arc in (("t", tapi, a_jax), ("j", japi, a_torch)):
        paths = [str(tmp_path / f"{tag}{j}") for j in range(outs)]
        api.decompress(arc, paths, verbose=False, num_threads=2,
                       read_range=(lo, hi))
        got[tag] = paths
    for a, b in zip(got["t"], got["j"]):
        assert filecmp.cmp(a, b, shallow=False)
    if kind == "pe" and outs == 2:
        for j, (p, o) in enumerate(zip(plain, got["t"])):
            want = _records(p)[max(lo - j * n, 0):max(min(hi - j * n, n), 0)]
            assert _records(o) == want
        assert len(_records(got["t"][int(second_file)])) == hi - lo
    else:
        assert len(_records(got["t"][0])) == hi - lo
