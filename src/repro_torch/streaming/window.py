"""Vectorized sliding-window aggregation (device tier), in PyTorch.

The port of ``repro/streaming/window.py``; its module docstring states the
frame/window convention, the emission loop and the drop counters, and
they hold here unchanged.  Events arrive as fixed-size tensor batches
``{ts, key, value, valid}``; per (frame slot, key bucket) partial
aggregates live in an ``(R, K)`` pane matrix:

* **accumulate** (Jet stage 1) adds the batch into the panes with the
  hand-written ``window_agg`` kernel (its plain version on CPU tensors);
* **emit** (Jet stage 2) emits every window whose end the watermark has
  reached, ``max_windows_per_step`` windows per ``(E, R) @ (R, K)`` round,
  and evicts the frame each emitted window retires.

Where the port differs from the reference in mechanism (not in result):

* State is updated **in place** (the reference's executor jits the step
  with ``donate_argnums=(0,)``, so nothing may hold the old state): the
  kernel adds into ``panes``, eviction zeroes only the evicted rows instead
  of rewriting the whole matrix, and the scalars are written with
  ``copy_``.  A caller that keeps a state across a step clones it first
  (``StreamExecutor.snapshot`` does).
* The emission ``lax.while_loop`` is driven from the host: each round ends
  in ONE device-to-host read that brings back the number of windows it
  emitted, the loop condition and the evicted slots, and one more read
  decides whether the first round runs.  A step costs ``rounds + 1`` host
  syncs, reported in its outputs.  The loop runs until the front passes the
  watermark or the output buffer fills, which can be up to ``EB - E + 1``
  rounds; it never predicates a fixed number of rounds.
* Out-of-range key buckets contribute nothing (the kernel's bounds check).
  The reference's flat scatter ``slot * K + key`` instead lands a valid row
  with a key outside ``[0, K)`` in a neighbouring slot's pane unless the
  flat index leaves ``[0, R*K)``; callers never feed such keys (buckets are
  ``key % K``), and ROADMAP.md logs the difference.

Every state scalar stays int32, and ``//`` and ``%`` on int32 tensors
floor as ``jnp`` does, so frame ids, slots and window ends match the
reference bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..kernels.window_agg import window_agg_into_

#: sentinel for "no frame / uninitialised emission front" (int32-safe)
_FAR = 2**30

@dataclasses.dataclass(frozen=True)
class VectorWindowSpec:
    size_ms: int
    slide_ms: int
    n_key_buckets: int = 1024
    max_windows_per_step: int = 4
    ring_margin: int = 4
    #: bounded out-of-orderness allowance subtracted from the data-driven
    #: watermark frontier (0 keeps the legacy max(ts) frontier)
    wm_lag: int = 0
    #: False = the watermark advances only on explicit ``wm`` hints (the
    #: host bridge mode: host watermarks are already lagged at the source)
    frontier_from_data: bool = True
    #: max emission rounds per step (0 = auto: ceil(ring_len / E), enough
    #: output rows to retire every live frame's next window in one step)
    emit_rounds: int = 0

    @property
    def frames_per_window(self) -> int:
        assert self.size_ms % self.slide_ms == 0
        return self.size_ms // self.slide_ms

    @property
    def ring_len(self) -> int:
        # the watermark lag keeps frames live for wm_lag/slide extra
        # slides past the emission front: size the ring for it, or the
        # admitted disorder would bleed straight into ring conflicts
        lag_frames = -(-self.wm_lag // self.slide_ms) if self.wm_lag else 0
        return self.frames_per_window + self.ring_margin + lag_frames

    @property
    def emit_rounds_resolved(self) -> int:
        if self.emit_rounds > 0:
            return self.emit_rounds
        return -(-self.ring_len // self.max_windows_per_step)

    @property
    def emit_buffer_rows(self) -> int:
        """Rows in a step's emission output (``results``/``window_ends``/
        ``valid`` leading dimension)."""
        return self.max_windows_per_step * self.emit_rounds_resolved


def window_state_init(spec: VectorWindowSpec,
                      device="cuda") -> Dict[str, torch.Tensor]:
    dev = torch.device(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return {
        # per (frame slot, key bucket) partial aggregate — slot-major so
        # the accumulate scatter lands without a transpose and emission is
        # one (E, R) @ (R, K) matmul
        "panes": torch.zeros((spec.ring_len, spec.n_key_buckets),
                             dtype=torch.float32, device=dev),
        # frame id stored in each ring slot (-1 = empty)
        "slot_frame": torch.full((spec.ring_len,), -1, dtype=torch.int32,
                                 device=dev),
        "watermark": scalar(-1),
        # next window end (ms) to emit; -1 = not yet initialised
        "next_emit": scalar(-1),
        "dropped_late": scalar(0),
        "dropped_conflict": scalar(0),
    }


def accumulate(spec: VectorWindowSpec, state: Dict, ts, key_bucket, value,
               valid, wm_hint=None) -> Dict:
    """Jet stage 1, vectorized pane accumulation, in place.

    ``wm_hint``: optional scalar watermark heartbeat (idle-source marker):
    advances event time without carrying data."""
    K, R, F = spec.n_key_buckets, spec.ring_len, spec.frames_per_window
    frame = (ts // spec.slide_ms).to(torch.int32)
    slot = frame % R                       # floor modulo: always in [0, R)

    # lateness: frames below min_frame have had their last window emitted
    ne = state["next_emit"]
    min_frame = torch.where(ne < 0, -(2**30), ne // spec.slide_ms - F)
    live = valid & (frame >= min_frame)
    n_late = (valid & ~live).sum(dtype=torch.int32)

    # ring-slot conflicts: slot occupied by a DIFFERENT still-live frame
    slot_frame = state["slot_frame"]
    occupant = slot_frame.index_select(0, slot)
    conflict = live & (occupant >= 0) & (occupant != frame)
    n_conflict = conflict.sum(dtype=torch.int32)
    live = live & ~conflict

    # the reference's scatter-add with mode="drop" (window.py:142-143):
    # the kernel's bounds check drops what the flat index would not hold
    window_agg_into_(state["panes"], key_bucket.to(torch.int32), slot,
                     value.to(torch.float32), live)

    # record which frame now lives in each touched slot.  The reference
    # scatter-maxes dead rows onto index R and drops them (window.py:147-148);
    # torch's scatter_reduce_ raises there, so dead rows scatter -1 onto
    # their own slot instead — a no-op under max, as slot_frame >= -1
    slot_frame.scatter_reduce_(0, slot.long(), torch.where(live, frame, -1),
                               reduce="amax")

    wm = state["watermark"]
    if spec.frontier_from_data:
        # bounded out-of-orderness: the frontier trails the running-max
        # timestamp by wm_lag, so cross-batch disorder within the
        # allowance is admitted instead of dropped as late
        frontier = torch.where(valid, ts, -1).amax().to(torch.int32) \
            - spec.wm_lag
        wm = torch.maximum(wm, frontier)
    if wm_hint is not None:
        wm = torch.maximum(wm, torch.as_tensor(wm_hint, dtype=torch.int32,
                                               device=wm.device))
    state["watermark"].copy_(wm)
    state["dropped_late"].add_(n_late)
    state["dropped_conflict"].add_(n_conflict)
    return state


@contextlib.contextmanager
def ieee_fp32_matmul() -> Iterator[None]:
    """Run float32 matmuls in full IEEE float32 inside the block, whatever
    the caller's global TF32 setting.  TF32 keeps 10 mantissa bits: a pane
    sum above 2048 (bid prices, large counts) would come out wrong."""
    # ``fp32_precision`` (torch >= 2.9) reads and sets the flag whichever
    # API the caller used; the legacy ``allow_tf32`` raises after the new
    # one was used
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev


def emit(spec: VectorWindowSpec, state: Dict
         ) -> Tuple[Dict, Dict[str, object]]:
    """Jet stage 2, vectorized: emit window results with end <= watermark;
    evict the frame each emission retires (state updated in place).

    Returns ``(state, out)``.  ``out`` holds the reference's outputs
    (``results`` ``(EB, K)``, ``window_ends`` ``(EB,)``, ``valid``
    ``(EB,)``) and three host ints: ``rows`` (the valid rows are exactly
    the prefix ``[0, rows)``), ``rounds`` and ``host_syncs``.
    """
    K, R, F = spec.n_key_buckets, spec.ring_len, spec.frames_per_window
    slide = spec.slide_ms
    E = spec.max_windows_per_step
    EB = spec.emit_buffer_rows

    wm = state["watermark"]
    panes, slot_frame = state["panes"], state["slot_frame"]
    dev = panes.device
    # first window end strictly beyond the watermark: reaching it means
    # emission is fully caught up
    caught = (wm // slide + 1) * slide

    def fast_forward(ne):
        """Smallest window end >= ne containing a live frame; if none is
        at or below the watermark, jump to ``caught`` (every window in
        between is empty — skipping it emits exactly nothing)."""
        live = slot_frame >= 0
        # frame f participates in windows ending (f+1)*slide..(f+F)*slide
        cand = torch.where(live & ((slot_frame + F) * slide >= ne),
                           torch.maximum(ne, (slot_frame + 1) * slide), _FAR)
        nxt = cand.min()
        return torch.where(ne >= _FAR, ne,
                           torch.where(nxt <= wm, nxt,
                                       torch.maximum(ne, caught)))

    # initialise next_emit from the first frame present
    first_frame = torch.where(slot_frame >= 0, slot_frame, _FAR).min()
    ne = torch.where(state["next_emit"] < 0,
                     torch.where(first_frame < _FAR, (first_frame + 1) * slide,
                                 _FAR),
                     state["next_emit"])
    ne = fast_forward(ne)

    res = torch.zeros((EB, K), dtype=panes.dtype, device=dev)
    ends = torch.zeros((EB,), dtype=torch.int32, device=dev)
    val = torch.zeros((EB,), dtype=torch.bool, device=dev)
    offsets = torch.arange(E, dtype=torch.int32, device=dev) * slide

    count = rounds = 0
    go = bool((ne <= wm) & (ne < _FAR))            # host sync 1
    with ieee_fp32_matmul():
        while go:
            # E candidate windows in ONE matmul: masks (E, R) @ panes (R, K)
            w_ends = ne + offsets
            ready = w_ends <= wm                                    # (E,)
            L = w_ends // slide - 1                                 # (E,)
            ring_f = slot_frame                                     # (R,)
            in_win = ((ring_f[None, :] > (L - F)[:, None])
                      & (ring_f[None, :] <= L[:, None])
                      & (ring_f[None, :] >= 0) & ready[:, None])
            masks = in_win.to(panes.dtype)                          # (E, R)
            results = masks @ panes                                 # (E, K)
            # evict every frame retired by an emitted window (single pass)
            evict = ((ring_f[None, :] == (L - F + 1)[:, None])
                     & ready[:, None]).any(dim=0) & (ring_f >= 0)
            slot_frame.masked_fill_(evict, -1)
            n_emitted = ready.sum(dtype=torch.int32)
            # the ready rows are a prefix of the E candidates (w_ends are
            # ascending), so advancing the cursor by n_emitted lets the next
            # round overwrite only the not-ready tail
            res[count:count + E] = results
            ends[count:count + E] = w_ends
            val[count:count + E] = ready
            ne = fast_forward(ne + n_emitted * slide)
            more = (ne <= wm) & (ne < _FAR)
            # the round's one host sync: emitted count, loop condition and
            # evicted slots (window.py:249's while_loop, driven from here)
            host = torch.cat([torch.stack([n_emitted, more.to(torch.int32)]),
                              evict.to(torch.int32)]).cpu().numpy()
            # zero only the evicted rows: the reference rewrites the whole
            # (R, K) matrix (window.py:236); in place, the result is equal
            for r in np.flatnonzero(host[2:]).tolist():
                panes[r].zero_()
            count += int(host[0])
            rounds += 1
            go = bool(host[1]) and count + E <= EB

    state["next_emit"].copy_(torch.where(ne < _FAR, ne, state["next_emit"]))
    return state, {"results": res, "window_ends": ends, "valid": val,
                   "rows": count, "rounds": rounds, "host_syncs": rounds + 1}


def step(spec: VectorWindowSpec, state: Dict, batch: Dict
         ) -> Tuple[Dict, Dict]:
    """One fused accumulate+emit step (the whole-DAG-per-chip tasklet)."""
    state = accumulate(spec, state, batch["ts"], batch["key"],
                       batch["value"], batch["valid"], batch.get("wm"))
    return emit(spec, state)
