"""CompressOptions.engine's ReorderConfig keys that the JAX package
reads from its environment at engine construction (num_walkers,
shift_chunk, accept_slots, far_near, cap_per_round): archives byte-equal
to spring_tpu.api.compress under the matching variables. The other
settings are in tests/test_torch_compress_options.py, whose helpers this
file runs."""
import pytest

pytest.importorskip("jax")

# fresh_programs (autouse) and reads are fixtures, used by name
from test_torch_compress_options import (  # noqa: E402,F401
    CASES, HERE, fresh_programs, option_archive_equals_jax, reads)


@pytest.mark.parametrize("case", [c for c in CASES if c not in HERE])
def test_engine_key_archive_equals_jax(tmp_path, monkeypatch, reads, case):
    option_archive_equals_jax(tmp_path, monkeypatch, reads, case)
