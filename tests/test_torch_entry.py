"""The port's entry points (spring_tpu_torch/entry.py) against
__graft_entry__.py (JAX on the CPU): the same synthetic reads, the same
round arguments and one round's state and emissions equal through
convert.py; dryrun_multichip(2) over gloo equals spring_tpu's
DistReorderEngine on a mesh of 2."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import __graft_entry__  # noqa: E402
from spring_tpu.parallel import dist as jdist  # noqa: E402
from spring_tpu_torch import convert  # noqa: E402
from spring_tpu_torch import entry as tentry  # noqa: E402


def test_synthetic_reads_are_the_jax_entrys():
    for a, b in zip(tentry._synthetic(1024, 96),
                    __graft_entry__._synthetic(1024, 96)):
        np.testing.assert_array_equal(a, b)


def test_entry_round_equals_jax():
    j_fn, j_args = __graft_entry__.entry()
    t_fn, t_args = tentry.entry("cpu")
    j_state, j_rest = j_args[0], j_args[1:]
    t_state, t_rest = t_args[0], t_args[1:]
    u32 = (False, True, False, False, False, False, True)   # dkeys, rows
    for t, j, u in zip(t_rest, j_rest, u32):
        np.testing.assert_array_equal(convert.to_numpy(t, uint32=u),
                                      np.asarray(j))
    want = {k: np.asarray(v) for k, v in j_state.items()}
    got = convert.state_to_numpy(t_state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    j_new, j_emit = j_fn(*j_args)
    t_new, t_emit = t_fn(*t_args)
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
    assert (np.asarray(j_emit)[:, :, 0] >= 0).sum() > 0
    got = convert.state_to_numpy(t_new)
    for k, v in j_new.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_dryrun_multichip_two_ranks_equals_jax():
    packed, lengths = __graft_entry__._synthetic(1024, 96)
    want = jdist.DistReorderEngine(packed, lengths,
                                   jdist.DistConfig(max_readlen=96),
                                   mesh=jdist.make_mesh(2)).run()
    got, ranks = tentry.dryrun_multichip(2, "cpu", timeout=240.0)
    np.testing.assert_array_equal(got, want)
    # every rank runs every round; the CPU launches no kernel
    assert len(ranks) == 2 and ranks[0] == ranks[1]
    assert ranks[0]["rounds_run"] > 0 and ranks[0]["launches"] == 0
