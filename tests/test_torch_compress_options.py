"""The compress options that reach the reorder engine's tuning paths:
spring_tpu_torch.api.CompressOptions.engine (each ReorderConfig field it
may set), min_contig_reads and stitch give archives byte-equal to
spring_tpu.api.compress under the environment variables and module
globals the JAX package reads for the same settings; an unknown engine
setting raises."""
import pytest

jax = pytest.importorskip("jax")

from spring_tpu import api as japi  # noqa: E402
from spring_tpu.parallel import dist as jdist  # noqa: E402
from spring_tpu.reorder import engine as jeng  # noqa: E402
from spring_tpu_torch import api as tapi  # noqa: E402
from spring_tpu_torch.reorder import engine as teng  # noqa: E402
from spring_tpu_torch.utils import synth  # noqa: E402

N_READS = 4096


@pytest.fixture(autouse=True)
def fresh_programs():
    """The JAX program caches are not keyed on FLUSH_ROUNDS, which a case
    patches: clear them (and the port's) around every case."""
    def clear():
        jeng._flush_program.cache_clear()
        jdist._dist_programs.cache_clear()
        tapi.clear_program_cache()
    clear()
    yield
    clear()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    fq = str(tmp_path_factory.mktemp("opts") / "in.fastq")
    synth.make_se(fq, N_READS, read_len=100, genome_size=N_READS * 100 // 30,
                  seed=77, n_rate=0.0005)
    return fq


# (options of the port, JAX environment variables, JAX engine globals)
CASES = {
    "num_walkers": (dict(engine=dict(num_walkers=64)),
                    {"SPRING_TPU_WALKERS": "64"}, {}),
    "shift_chunk": (dict(engine=dict(shift_chunk=8)),
                    {"SPRING_TPU_SC": "8"}, {}),
    "accept_slots": (dict(engine=dict(accept_slots=8)),
                     {"SPRING_TPU_SLOTS": "8"}, {}),
    "far_near": (dict(engine=dict(far_near=4)),
                 {"SPRING_TPU_FARDICT": "4"}, {}),
    "cap_per_round": (dict(engine=dict(cap_per_round=6)),
                      {"SPRING_TPU_CAP_PER_ROUND": "6"}, {}),
    "rebuild_fraction": (dict(engine=dict(rebuild_fraction=0.05)), {},
                         {"REBUILD_FRACTION": 0.05}),
    "flush_rounds": (dict(engine=dict(flush_rounds=16)), {},
                     {"FLUSH_ROUNDS": 16}),
    "min_contig_reads": (dict(min_contig_reads=50),
                         {"SPRING_TPU_MIN_CONTIG": "50"}, {}),
    "stitch": (dict(stitch=False), {"SPRING_TPU_STITCH": "0"}, {}),
}


# the cases of this file; tests/test_torch_compress_engine_keys.py runs
# the others (two files, so that the tier-1 run's --dist loadfile can
# spread them over workers)
HERE = ("rebuild_fraction", "flush_rounds", "min_contig_reads", "stitch")


def option_archive_equals_jax(tmp_path, monkeypatch, reads, case):
    """Compress ``reads`` with both packages under ``case`` of CASES: the
    archives byte-equal, the rounds equal."""
    fields, env, globs = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in globs.items():
        monkeypatch.setattr(jeng, k, v)
    a_jax, a_torch = str(tmp_path / "jax.stpu"), str(tmp_path / "t.stpu")
    japi.compress([reads], a_jax, japi.CompressOptions(num_threads=2,
                                                       verbose=False))
    j_stats = dict(jeng.LAST_RUN_STATS)
    tapi.compress([reads], a_torch, tapi.CompressOptions(
        num_threads=2, verbose=False, **fields), device="cpu")
    stats = teng.LAST_RUN_STATS
    with open(a_jax, "rb") as f1, open(a_torch, "rb") as f2:
        assert f1.read() == f2.read()
    assert stats["rounds"] == j_stats["rounds"]
    if case == "rebuild_fraction":
        assert stats["dict_compactions"] >= 1
    if case == "flush_rounds":
        assert stats["rounds_run"] == stats["flushes"] * 16


@pytest.mark.parametrize("case", HERE)
def test_option_archive_equals_jax(tmp_path, monkeypatch, reads, case):
    option_archive_equals_jax(tmp_path, monkeypatch, reads, case)


def test_options_change_the_archive(tmp_path, reads):
    """Each setting is live: the archives of far_near 4, stitch off and
    a minimum contig of 50 reads all differ from the default's."""
    sizes = {}
    for name, fields in (("default", {}),
                         ("far_near", dict(engine=dict(far_near=4))),
                         ("stitch", dict(stitch=False)),
                         ("min_contig", dict(min_contig_reads=50))):
        out = str(tmp_path / f"{name}.stpu")
        tapi.compress([reads], out, tapi.CompressOptions(
            num_threads=2, verbose=False, **fields), device="cpu")
        with open(out, "rb") as f:
            sizes[name] = f.read()
    for name in ("far_near", "stitch", "min_contig"):
        assert sizes[name] != sizes["default"], name


def test_unknown_engine_setting_raises(reads):
    with pytest.raises(ValueError, match="far_far"):
        tapi.compress([reads], reads + ".stpu", tapi.CompressOptions(
            verbose=False, engine=dict(far_far=4)), device="cpu")
