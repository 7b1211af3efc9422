"""Entry points of the port: the counterparts of __graft_entry__.py.

entry(device)               -> (round_fn, args): one reorder matching round
                               of the single-device engine (dictionary
                               probe, fused fetch-and-verify kernel,
                               consensus update) and its arguments, on
                               1,024 synthetic reads of 96 bases.
dryrun_multichip(n, device) -> the distributed reorder engine over n ranks
                               (multihost.launch: NCCL on cards, gloo on the
                               CPU) on the same reads: its emissions, checked,
                               and each rank's kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from .io import packing
from .ops import kernels
from .parallel import dist, multihost
from .reorder import dictionary as dct
from .reorder import engine as eng

N_READS = 1024
READ_LEN = 96


def _synthetic(n_reads: int, L: int, seed: int = 0):
    """n_reads reads of L bases cut from a random genome: packed rows and
    lengths (the input of __graft_entry__._synthetic, bit for bit)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=max(4 * n_reads, 2 * L)).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, size=n_reads)
    codes = np.stack([genome[s:s + L] for s in starts])
    lengths = np.full(n_reads, L, np.int32)
    return packing.pack_codes(codes), lengths


def entry(device="cuda"):
    """The engine's round function and the arguments of its first round:
    (state, lengths, dkeys, pairs_all, seed_order, n_real, maxshift,
    rows_tab), every tensor on ``device``. ``round_fn(*args)`` returns
    (new state, emissions)."""
    packed, lengths = _synthetic(N_READS, READ_LEN)
    cfg = eng.ReorderConfig(max_readlen=READ_LEN)
    e = eng.ReorderEngine(packed, lengths, cfg, device=device)
    state = e._init_state()
    rows_tab = state.pop("rows")
    dkeys = torch.cat([d.btab for d in e.dicts], dim=0)
    pairs_all = torch.cat([dct.pairs_from_rids(d.rids) for d in e.dicts],
                          dim=0)
    seed_order = torch.arange(e.Np, dtype=torch.int32, device=e.device)
    round_fn = eng._flush_program(
        e.Np, cfg.candidates, cfg.shift_chunk, cfg.accept_slots,
        tuple(w.start for w in e.windows), cfg.thresh, cfg.far_near,
        cfg.cap_per_round, cfg.flush_rounds)[0]
    scalar = dict(dtype=torch.int32, device=e.device)
    args = (state, e.lengths, dkeys, pairs_all, seed_order,
            torch.tensor(e.N, **scalar), torch.tensor(cfg.max_shift, **scalar),
            rows_tab)
    return round_fn, args


def _dryrun_rank(world: multihost.World) -> tuple:
    """One rank of dryrun_multichip: the distributed engine on the
    synthetic reads; its emissions, and its round kernel's launches
    (counted from 0) and rounds run."""
    packed, lengths = _synthetic(N_READS, READ_LEN)
    kernels.masked_hamming_rows.launches = 0
    em = dist.DistReorderEngine(
        packed, lengths, dist.DistConfig(max_readlen=READ_LEN),
        world=world).run()
    return em, dict(launches=kernels.masked_hamming_rows.launches,
                    rounds_run=eng.LAST_RUN_STATS["rounds_run"])


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> tuple:
    """The sharded reorder of the synthetic reads on ``n_devices`` ranks,
    one process each (on cards one card a rank). Every rank must return
    the same emissions, and they must place every read exactly once: a
    sharded engine that mis-emits raises here instead of merely
    finishing. Returns the emissions (rid, flag, pos_delta, rc) and each
    rank's launches of the round's kernel and rounds run."""
    res = multihost.launch(_dryrun_rank, n_devices, (), device=device,
                           timeout=timeout)
    em = res[0][0]
    for r, (other, _) in enumerate(res[1:], 1):
        if not np.array_equal(em, other):
            raise AssertionError(f"dryrun_multichip: rank {r}'s emissions "
                                 "differ from rank 0's")
    rids = np.sort(em[:, 0])
    if not np.array_equal(rids, np.arange(N_READS)):
        raise AssertionError(
            f"dryrun_multichip: {len(em)} emissions over "
            f"{len(np.unique(rids))} distinct reads of {N_READS}")
    return em, [r[1] for r in res]
