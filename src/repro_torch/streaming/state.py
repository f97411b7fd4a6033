"""Carry an executor state between the JAX package and the port.

The reference's state is a dict of device arrays; ``{k: np.asarray(v)}``
of it is what :func:`state_from_numpy` takes, so a JAX run stopped
mid-stream continues in the port.  :func:`state_to_numpy` goes back.
Dtypes and shapes are checked, never converted: panes float32 ``(R, K)``,
``slot_frame`` int32 ``(R,)``, every other entry an int32 scalar.

On a mesh the reference's ``np.asarray`` of a sharded state is the whole
state; the port holds one shard a rank.  :func:`shard_state` cuts rank
``r``'s shard out of a whole state (key buckets block-wise, panes
columns ``[r K / n, (r + 1) K / n)``, the rest replicated) and
:func:`gather_state` puts the shards of all ranks back together.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

_SCALARS = ("watermark", "next_emit", "dropped_late", "dropped_conflict")


def _check(np_state: Dict[str, np.ndarray]) -> None:
    keys = {"panes", "slot_frame", *_SCALARS}
    if set(np_state) != keys:
        raise ValueError(f"state keys {sorted(np_state)}, expected "
                         f"{sorted(keys)}")
    panes, sf = np_state["panes"], np_state["slot_frame"]
    if panes.dtype != np.float32 or panes.ndim != 2:
        raise ValueError(f"panes must be float32 (R, K), got {panes.dtype} "
                         f"{panes.shape}")
    if sf.dtype != np.int32 or sf.shape != panes.shape[:1]:
        raise ValueError(f"slot_frame must be int32 {panes.shape[:1]}, got "
                         f"{sf.dtype} {sf.shape}")
    for k in _SCALARS:
        if np_state[k].dtype != np.int32 or np_state[k].shape != ():
            raise ValueError(f"{k} must be an int32 scalar, got "
                             f"{np_state[k].dtype} {np_state[k].shape}")


def state_from_numpy(np_state: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's state from numpy leaves (copied, so the port's in-place
    updates never write into the caller's arrays)."""
    arrays = {k: np.array(v, copy=True) for k, v in np_state.items()}
    _check(arrays)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def shard_state(np_state: Dict[str, np.ndarray], rank: int,
                n_shards: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s shard of a whole numpy state (copies)."""
    _check(np_state)
    K = np_state["panes"].shape[1]
    if K % n_shards or not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} of {n_shards} shards of {K} buckets")
    k_loc = K // n_shards
    out = {k: np.array(v, copy=True) for k, v in np_state.items()}
    out["panes"] = np.ascontiguousarray(
        np_state["panes"][:, rank * k_loc:(rank + 1) * k_loc])
    return out


def gather_state(shards: Sequence[Dict[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
    """The whole numpy state from every rank's shard, in rank order; the
    replicated entries must agree on every rank."""
    for sh in shards:
        _check(sh)
    whole = {k: np.array(v, copy=True) for k, v in shards[0].items()
             if k != "panes"}
    for r, sh in enumerate(shards[1:], 1):
        for k, v in whole.items():
            if not np.array_equal(sh[k], v):
                raise ValueError(f"{k} differs between rank 0 and rank {r}")
    whole["panes"] = np.concatenate([sh["panes"] for sh in shards], axis=1)
    return whole
