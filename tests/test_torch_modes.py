"""Every single-device mode of spring_tpu_torch.api.compress (device "cpu")
against spring_tpu.api.compress (JAX on the CPU) on the same synthetic
input, made from a seed with the port's own utils/synth.py. Tolerance:
exact. The two archives must be byte-equal, and the port's own decompress
must give back the input where the mode is lossless and order-preserving.
Super-shard archives are in tests/test_torch_shards.py."""
import filecmp
import gzip
import os

import pytest

pytest.importorskip("jax")

from spring_tpu import api as japi  # noqa: E402
from spring_tpu_torch import api as tapi  # noqa: E402
from spring_tpu_torch import params as tP  # noqa: E402
from spring_tpu_torch.reorder import engine as teng  # noqa: E402
from spring_tpu_torch.utils import synth  # noqa: E402

N = 2048            # reads (SE) or pairs (PE)

# name -> (paired, input form, CompressOptions fields)
MODES = {
    "pe": (True, "fastq", {}),
    "se_reorder": (False, "fastq", {"reorder": True}),
    "pe_reorder": (True, "fastq", {"reorder": True}),
    "ill_bin": (False, "fastq", {"quality_mode": "ill_bin"}),
    "binary": (False, "fastq", {"quality_mode": "binary",
                                "bin_thresholds": (53, 73, 35)}),
    "qvz": (False, "fastq", {"quality_mode": "qvz", "qvz_ratio": 1.0}),
    "no_quality": (False, "fastq", {"preserve_quality": False}),
    "no_ids": (False, "fastq", {"preserve_id": False}),
    "fasta": (False, "fasta", {"fasta_input": True}),
    "gz_input": (False, "gz", {}),
    "long": (False, "fastq", {"long_mode": True}),
    "pe_long": (True, "fastq", {"long_mode": True}),
}
LOSSLESS_ORDERED = ("pe", "gz_input", "long", "pe_long", "fasta")


def _to_fasta(fq: str) -> str:
    out = fq[:-1] + "a"
    with open(fq, "rb") as f, open(out, "wb") as o:
        lines = f.read().split(b"\n")
        for i in range(0, len(lines) - 1, 4):
            o.write(b">" + lines[i][1:] + b"\n" + lines[i + 1] + b"\n")
    return out


def _to_gz(fq: str) -> str:
    with open(fq, "rb") as f, gzip.open(fq + ".gz", "wb") as o:
        o.write(f.read())
    return fq + ".gz"


def _inputs(tmp_path, paired: bool, form: str, n: int, seed: int):
    """(files to compress, plain files they hold)."""
    kw = dict(read_len=100, genome_size=n * 100 // 30, seed=seed,
              n_rate=0.0005)
    plain = [str(tmp_path / "r1.fastq")]
    if paired:
        plain.append(str(tmp_path / "r2.fastq"))
        synth.make_pe(plain[0], plain[1], n, insert_mean=220.0, **kw)
    else:
        synth.make_se(plain[0], n, **kw)
    if form == "fasta":
        plain = [_to_fasta(p) for p in plain]
        return plain, plain
    if form == "gz":
        return [_to_gz(p) for p in plain], plain
    return plain, plain


def _both(tmp_path, files, fields):
    a_jax, a_torch = str(tmp_path / "jax.stpu"), str(tmp_path / "torch.stpu")
    japi.compress(files, a_jax, japi.CompressOptions(
        num_threads=2, verbose=False, **fields))
    tapi.compress(files, a_torch, tapi.CompressOptions(
        num_threads=2, verbose=False, **fields), device="cpu")
    return a_jax, a_torch


@pytest.mark.parametrize("mode", list(MODES))
def test_archive_byte_equal(tmp_path, mode):
    paired, form, fields = MODES[mode]
    files, plain = _inputs(tmp_path, paired, form, N, seed=len(mode) + 17)
    a_jax, a_torch = _both(tmp_path, files, fields)
    assert filecmp.cmp(a_jax, a_torch, shallow=False)
    if not fields.get("long_mode"):
        assert teng.LAST_RUN_STATS["rounds"] > 0
    if mode in LOSSLESS_ORDERED:
        outs = [str(tmp_path / f"o{j}") for j in range(len(plain))]
        tapi.decompress(a_torch, outs, verbose=False, num_threads=2)
        for p, o in zip(plain, outs):
            assert filecmp.cmp(p, o, shallow=False)


def test_above_cap_without_stride_room_raises(tmp_path, monkeypatch):
    """A cap below the checkpoint stride cannot be sharded: the port
    raises as spring_tpu does, it writes no partial archive member."""
    monkeypatch.setattr(tP, "MAX_NUM_READS_SHORT", 1024)
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 1500, read_len=100, genome_size=5000, seed=2)
    with pytest.raises(ValueError, match="checkpoint stride"):
        tapi.compress([fq], str(tmp_path / "a.stpu"),
                      tapi.CompressOptions(num_threads=2, verbose=False),
                      device="cpu")


def test_cli_modes_on_cpu(tmp_path):
    """The port's CLI takes spring_tpu's flags: PE -r with lossy quality
    in, gzip out, with its own decompress."""
    from spring_tpu_torch import cli
    files, plain = _inputs(tmp_path, True, "fastq", 600, seed=4)
    arc = str(tmp_path / "a.stpu")
    outs = [str(tmp_path / "o1.gz"), str(tmp_path / "o2.gz")]
    assert cli.main(["-c", "-i", *files, "-o", arc, "-r", "-q", "ill_bin",
                     "--device", "cpu", "-t", "2", "--quiet"]) == 0
    assert cli.main(["-d", "-i", arc, "-o", *outs, "-g", "-t", "2",
                     "--quiet"]) == 0

    def records(path, gz):
        with (gzip.open(path, "rb") if gz else open(path, "rb")) as f:
            lines = f.read().split(b"\n")
        return [tuple(lines[i:i + 2]) for i in range(0, len(lines) - 1, 4)]

    want = sorted(zip(records(plain[0], False), records(plain[1], False)))
    got = sorted(zip(records(outs[0], True), records(outs[1], True)))
    assert want == got
    assert os.path.getsize(arc) > 0
