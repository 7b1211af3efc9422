"""End to end: spring_tpu_torch.api.compress (device "cpu") writes archives
byte-equal to spring_tpu.api.compress on synthetic single-end sets, they
round-trip byte-exact, and the port runs with jax and spring_tpu blocked."""
import filecmp
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from spring_tpu import api as japi  # noqa: E402
from spring_tpu_torch import api as tapi  # noqa: E402
from spring_tpu_torch.pipeline import short_mode as tshort  # noqa: E402
from spring_tpu_torch.reorder import engine as teng  # noqa: E402
from spring_tpu_torch.utils import synth  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _opts():
    return japi.CompressOptions(num_threads=2, verbose=False)


@pytest.mark.parametrize("n_reads", [4096, 16384])
def test_se_archive_byte_equal_and_roundtrip(tmp_path, n_reads):
    fq = str(tmp_path / "in.fastq")
    # ~40x coverage, 1% substitutions, some N bases: N-reads and
    # singleton contigs go through second chance
    synth.make_se(fq, n_reads, read_len=100, genome_size=n_reads * 100 // 40,
                  seed=n_reads, n_rate=0.0005)
    a_jax, a_torch = str(tmp_path / "jax.stpu"), str(tmp_path / "torch.stpu")
    japi.compress([fq], a_jax, _opts())
    tapi.compress([fq], a_torch, _opts(), device="cpu")
    assert teng.LAST_RUN_STATS["rounds"] > 0
    assert "second_chance" in tshort.LAST_STAGE_SECONDS
    with open(a_jax, "rb") as f1, open(a_torch, "rb") as f2:
        assert f1.read() == f2.read()
    out = str(tmp_path / "out.fastq")
    tapi.decompress(a_torch, [out], verbose=False, num_threads=2)
    assert filecmp.cmp(fq, out, shallow=False)


def test_cli_compress_on_cpu(tmp_path):
    from spring_tpu_torch import cli
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 1000, read_len=100, genome_size=4000, seed=3)
    arc, out = str(tmp_path / "a.stpu"), str(tmp_path / "o.fastq")
    assert cli.main(["-c", "-i", fq, "-o", arc, "--device", "cpu",
                     "-t", "2", "--quiet"]) == 0
    assert cli.main(["-d", "-i", arc, "-o", out, "-t", "2",
                     "--quiet"]) == 0
    assert filecmp.cmp(fq, out, shallow=False)
    assert cli.main(["-c", "-i", str(tmp_path / "missing.fastq"), "-o", arc,
                     "--device", "cpu", "--quiet"]) == 1


def test_port_runs_without_jax(tmp_path):
    """With jax AND spring_tpu blocked from import, spring_tpu_torch
    imports, compresses a small file on the CPU and decompresses it with
    its own code, byte-exact."""
    fq = str(tmp_path / "in.fastq")
    synth.make_se(fq, 2000, read_len=100, genome_size=5000, seed=5)
    code = (
        "import filecmp, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['spring_tpu'] = None\n"
        "from spring_tpu_torch import api\n"
        f"api.compress([{fq!r}], {fq + '.stpu'!r},\n"
        "             api.CompressOptions(num_threads=2, verbose=False),\n"
        "             device='cpu')\n"
        f"api.decompress({fq + '.stpu'!r}, [{fq + '.out'!r}],\n"
        "               num_threads=2, verbose=False)\n"
        f"assert filecmp.cmp({fq!r}, {fq + '.out'!r}, shallow=False)\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['spring_tpu'] is None\n"
        "assert not any(m.startswith(('jax.', 'spring_tpu.'))\n"
        "               or m == 'jaxlib' for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
    # and spring_tpu reads what the blocked process wrote
    out = fq + ".jax.out"
    japi.decompress(fq + ".stpu", [out], verbose=False, num_threads=2)
    assert filecmp.cmp(fq, out, shallow=False)


def test_port_sources_import_nothing_of_jax_or_spring_tpu():
    """No file of the port (the package, chip_smoke.py, the profile tool)
    has an import of jax or of the spring_tpu package, a path built into
    spring_tpu/, or a SPRING_TPU_* environment variable."""
    imp = re.compile(r"^\s*(from|import)\s+(jax|spring_tpu)(\.|\s|$)")
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profile_torch_engine.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "spring_tpu_torch")):
        paths += [os.path.join(root, f) for f in names
                  if f.endswith((".py", ".cpp", ".h", ".cu"))]
    assert len(paths) > 30
    bad = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                code = line.split("#", 1)[0]
                if "sys.modules[" in code:      # the import block itself
                    continue
                if (imp.match(line) or "spring_tpu.__file__" in code
                        or re.search(r"[\"']spring_tpu[\"']|spring_tpu/csrc",
                                     code)
                        or "SPRING_TPU_" in code):
                    bad.append(f"{os.path.relpath(p, REPO)}:{i}: "
                               f"{line.strip()}")
    assert not bad, "\n".join(bad)
