"""Carry engine state between the JAX package and the port.

This system has no weights; what crosses between spring_tpu and the port
is device state: the reorder engine's state dict, the dictionary tables
and the packed row table. On the JAX side they are numpy arrays (uint32
for packed words, int32/bool otherwise); in the port, packed words are
int32 tensors holding the same bit patterns. These helpers convert both
ways without changing a bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .reorder import dictionary as dct

# engine state fields (and the row table) that hold packed uint32 words
STATE_U32 = ("counts", "claimed", "rows")


def to_torch(a, device="cuda") -> torch.Tensor:
    """numpy array (or array-like) -> tensor on ``device``; uint32 arrays
    become int32 tensors of the same bit patterns."""
    a = np.array(a, order="C")          # a writable copy; keeps 0-d shape
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device)


def to_numpy(t: torch.Tensor, uint32: bool = False) -> np.ndarray:
    """tensor -> numpy array; ``uint32`` views int32 patterns as uint32."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a


def state_to_torch(state: dict, device="cuda") -> dict:
    """JAX engine state dict (engine.py _init_state) -> port state."""
    return {k: to_torch(v, device) for k, v in state.items()}


def state_to_numpy(state: dict) -> dict:
    """Port state -> numpy arrays in the JAX dtypes."""
    return {k: to_numpy(v, uint32=k in STATE_U32) for k, v in state.items()}


# ---- the distributed engine (parallel/dist.py) ----
#
# On the JAX side a field of the distributed state, or an output of the
# sharded build, is one global array laid out over the mesh on dim 0
# (``claimed`` alone is replicated). In the port each rank holds its block
# of a sharded field and the whole of a replicated one.

DIST_REPLICATED = ("claimed",)
# outputs of the sharded build, in order; all sharded on dim 0
DIST_BUILD_FIELDS = ("btab", "keys", "rids", "pairs", "dropped")
DIST_BUILD_U32 = ("btab", "keys")


def shard_to_torch(a, rank: int, size: int, device="cuda") -> torch.Tensor:
    """Rank ``rank``'s block of dim 0 of a global array, as a tensor."""
    a = np.asarray(a)
    if a.shape[0] % size:
        raise ValueError(f"dim 0 of {a.shape} does not split over {size}")
    rows = a.shape[0] // size
    return to_torch(a[rank * rows:(rank + 1) * rows], device)


def dist_state_to_torch(state: dict, rank: int, size: int,
                        device="cuda") -> dict:
    """JAX distributed state (global arrays) -> one rank's port state."""
    return {k: (to_torch(v, device) if k in DIST_REPLICATED
                else shard_to_torch(v, rank, size, device))
            for k, v in state.items()}


def dist_state_to_numpy(states: list) -> dict:
    """Every rank's port state, in rank order -> global numpy arrays in
    the JAX dtypes. A replicated field must be the same on every rank."""
    out = {}
    for k in states[0]:
        parts = [to_numpy(s[k], uint32=k in STATE_U32) for s in states]
        if k in DIST_REPLICATED:
            for p in parts[1:]:
                if not np.array_equal(p, parts[0]):
                    raise ValueError(f"replicated field {k} differs "
                                     "between ranks")
            out[k] = parts[0]
        else:
            out[k] = np.concatenate(parts)
    return out


def dist_build_to_torch(build: dict, rank: int, size: int,
                        device="cuda") -> dict:
    """The JAX sharded build's global outputs -> one rank's tensors."""
    return {k: shard_to_torch(build[k], rank, size, device)
            for k in DIST_BUILD_FIELDS}


def dist_build_to_numpy(builds: list) -> dict:
    """Every rank's build outputs, in rank order -> global numpy arrays
    in the JAX dtypes."""
    return {k: np.concatenate([to_numpy(b[k], uint32=k in DIST_BUILD_U32)
                               for b in builds])
            for k in DIST_BUILD_FIELDS}


def dict_to_torch(btab, rids, keys, start: int, dropped: int = 0,
                  device="cuda") -> dct.DeviceDict:
    """A JAX DeviceDict's arrays (btab/keys uint32, rids int32) -> the
    port's DeviceDict."""
    return dct.DeviceDict(
        btab=to_torch(btab, device), rids=to_torch(rids, device),
        keys_dev=to_torch(keys, device), start=start,
        dropped=torch.tensor(int(dropped), dtype=torch.int32,
                             device=device))


def dict_to_numpy(d: dct.DeviceDict) -> dict:
    """The port's DeviceDict -> numpy arrays in the JAX dtypes."""
    return dict(btab=to_numpy(d.btab, uint32=True), rids=to_numpy(d.rids),
                keys=to_numpy(d.keys_dev, uint32=True), start=d.start,
                dropped=int(d.dropped))
