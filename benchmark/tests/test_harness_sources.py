"""The generator's copy against the port's generator, and an import walk
over every module a run loads."""
import ast
import filecmp
import os

import pytest

from harness import synth

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "spring_tpu"}


@pytest.mark.parametrize("kw", [
    dict(qual_levels=40), dict(qual_levels=8),
    dict(qual_levels=40, n_rate=0.003, err_rate=0.02)])
def test_generator_writes_the_ports_bytes(tmp_path, monkeypatch, kw):
    from spring_tpu_torch.utils import synth as port
    monkeypatch.setattr(synth, "ROWS", 1000)     # several tasks a mate
    a = [str(tmp_path / f"a{m}.fq") for m in (1, 2)]
    b = [str(tmp_path / f"b{m}.fq") for m in (1, 2)]
    port.make_pe(*a, 2501, genome_size=30000, seed=2**31 + 7, **kw)
    synth.make_pe(*b, 2501, genome_size=30000, seed=2**31 + 7, **kw)
    assert all(filecmp.cmp(x, y, shallow=False) for x, y in zip(a, b))


def _imports(path: str) -> set:
    """Top-level names of every module a Python file imports (relative
    imports are the file's own package)."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
    return out


def _sources(top: str):
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", ".cache")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_run_module_imports_jax_or_the_jax_package():
    """The benchmark and the program it runs, compared by whole
    top-level names (``spring_tpu_torch`` is not ``spring_tpu``)."""
    for top in (BENCH, os.path.join(ROOT, "spring_tpu_torch")):
        for path in _sources(top):
            if os.sep + "tests" + os.sep in path:
                continue
            bad = _imports(path) & FORBIDDEN
            assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"spring_tpu_torch", "torch",
                                         "harness"}), (path, names)
