"""The port's own decompress against spring_tpu's: each package reads the
archive the other wrote (SE and PE, made from a seed with the port's
utils/synth.py), whole, with gzip output, and with a read range.
Tolerance: exact (byte-equal files)."""
import filecmp
import gzip

import pytest

pytest.importorskip("jax")

import test_torch_modes as modes  # noqa: E402
from spring_tpu import api as japi  # noqa: E402
from spring_tpu_torch import api as tapi  # noqa: E402

N = 3000            # reads (SE) or pairs (PE)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """kind -> (plain inputs, spring_tpu archive, port archive)."""
    out = {}
    for kind, paired, form, fields in (
            ("se", False, "fastq", {}),
            ("pe", True, "fastq", {}),
            ("se_fasta", False, "fasta", {"fasta_input": True}),
            ("pe_long", True, "fastq", {"long_mode": True})):
        d = tmp_path_factory.mktemp(kind)
        files, plain = modes._inputs(d, paired, form, N, seed=len(kind))
        out[kind] = (plain, *modes._both(d, files, fields))
    return out


def _pick(archives, kind, reader):
    """(api that reads, archive written by the other package)."""
    plain, a_jax, a_torch = archives[kind]
    if reader == "port_reads_jax":
        return plain, tapi, a_jax
    return plain, japi, a_torch


def _records(path, lines_per):
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [tuple(lines[i:i + lines_per])
            for i in range(0, len(lines) - 1, lines_per)]


READERS = ["port_reads_jax", "jax_reads_port"]
KINDS = ["se", "pe", "se_fasta", "pe_long"]


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("kind", KINDS)
def test_cross_decompress_byte_equal(archives, tmp_path, kind, reader):
    plain, api, arc = _pick(archives, kind, reader)
    outs = [str(tmp_path / f"o{j}") for j in range(len(plain))]
    cp = api.decompress(arc, outs, verbose=False, num_threads=2)
    assert cp.num_reads == N * len(plain)
    for p, o in zip(plain, outs):
        assert filecmp.cmp(p, o, shallow=False)


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("kind", ["se", "pe"])
def test_cross_decompress_gzip_output(archives, tmp_path, kind, reader):
    plain, api, arc = _pick(archives, kind, reader)
    outs = [str(tmp_path / f"o{j}.gz") for j in range(len(plain))]
    api.decompress(arc, outs, gzipped=True, verbose=False, num_threads=2)
    for p, o in zip(plain, outs):
        with gzip.open(o, "rb") as f, open(p, "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_gzip_output_bytes_equal_between_packages(archives, tmp_path, kind):
    plain, a_jax, a_torch = archives[kind]
    oj = [str(tmp_path / f"j{j}.gz") for j in range(len(plain))]
    ot = [str(tmp_path / f"t{j}.gz") for j in range(len(plain))]
    japi.decompress(a_jax, oj, gzipped=True, verbose=False, num_threads=2)
    tapi.decompress(a_torch, ot, gzipped=True, verbose=False, num_threads=2)
    for a, b in zip(oj, ot):
        assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("kind,rng", [
    ("se", (0, 1)), ("se", (1234, 2345)), ("se", (2990, 3000)),
    ("se_fasta", (10, 700)), ("pe", (100, 1500)), ("pe", (2500, 3500)),
    ("pe", (3100, 5999)), ("pe", (0, 6000)), ("pe_long", (17, 4100))])
def test_cross_decompress_range(archives, tmp_path, kind, rng, reader):
    """--decompress-range over the global index space (file-1 reads, then
    file-2 reads): output j holds its file's part of the range, equal to
    the same slice of input j."""
    plain, api, arc = _pick(archives, kind, reader)
    outs = [str(tmp_path / f"o{j}") for j in range(len(plain))]
    api.decompress(arc, outs, verbose=False, num_threads=2, read_range=rng)
    per = 2 if kind == "se_fasta" else 4
    for j, (p, o) in enumerate(zip(plain, outs)):
        lo = max(rng[0] - j * N, 0)
        hi = max(min(rng[1] - j * N, N), 0)
        assert _records(o, per) == _records(p, per)[lo:hi]


@pytest.mark.parametrize("rng", [None, (2000, 4000), (2500, 3500)])
def test_pe_single_output_equal_between_packages(archives, tmp_path, rng):
    """A PE archive into one output file (file-1 reads, then file-2
    reads, ranges over the joint index space)."""
    _plain, a_jax, a_torch = archives["pe"]
    oj, ot = str(tmp_path / "j"), str(tmp_path / "t")
    japi.decompress(a_torch, [oj], verbose=False, num_threads=2,
                    read_range=rng)
    tapi.decompress(a_jax, [ot], verbose=False, num_threads=2,
                    read_range=rng)
    assert filecmp.cmp(oj, ot, shallow=False)
    lo, hi = rng or (0, 2 * N)
    assert len(_records(ot, 4)) == hi - lo


def test_decompress_rejects_bad_requests(archives, tmp_path):
    _plain, _a_jax, a_torch = archives["se"]
    out = str(tmp_path / "o")
    with pytest.raises(ValueError, match="invalid read range"):
        tapi.decompress(a_torch, [out], verbose=False, read_range=(5, 5))
    with pytest.raises(ValueError, match="invalid read range"):
        tapi.decompress(a_torch, [out], verbose=False,
                        read_range=(0, N + 1))
    with pytest.raises(ValueError, match="exactly 1 output"):
        tapi.decompress(a_torch, [out, out + "2"], verbose=False)
