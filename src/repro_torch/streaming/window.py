"""Vectorized sliding-window aggregation (device tier), in PyTorch.

The port of ``repro/streaming/window.py``; its module docstring states the
frame/window convention, the emission loop and the drop counters, and
they hold here unchanged.  Events arrive as fixed-size tensor batches
``{ts, key, value, valid}``; per (frame slot, key bucket) partial
aggregates live in an ``(R, K)`` pane matrix:

* **accumulate** (Jet stage 1) adds the batch into the panes: on a card
  ONE launch of the hand-written ``accumulate`` kernel
  (``kernels/window_agg.py``; lateness, ring conflicts, the pane
  scatter-add, the ``slot_frame`` update, the drop counters and the
  watermark), on CPU tensors its plain version;
* **emit** (Jet stage 2) emits every window whose end the watermark has
  reached, ``max_windows_per_step`` windows a round, and evicts the frame
  each emitted window retires: on a card ONE launch of the hand-written
  ``emit`` kernel runs every round of the step, on CPU tensors its plain
  version (``kernels/window_agg.py``).

Where the port differs from the reference in mechanism (not in result):

* State is updated **in place** (the reference's executor jits the step
  with ``donate_argnums=(0,)``, so nothing may hold the old state): the
  kernel adds into ``panes`` and writes ``slot_frame`` and the scalars,
  eviction zeroes only the evicted rows instead of rewriting the whole
  matrix.  A caller that keeps a state across a step clones it first
  (``StreamExecutor.snapshot`` does).
* The emission ``lax.while_loop`` runs on the card inside one kernel
  launch: the front, the fast-forward over empty windows and the rounds'
  stopping rule (the front passes the watermark or the next round would
  not fit the output buffer) are computed there from ``slot_frame`` and
  the watermark, and the host reads the kernel's two-int status (rows
  emitted, rounds run) once a step.  A step costs one host sync on a card;
  the plain version drives the loop from the host, with a read before the
  first round and one after each (``rounds + 1``).  Both report theirs in
  the outputs.  The windows' sums are IEEE float32 on both (compensated
  in the kernel, one cuBLAS product a round in the plain version).
* The pane scatter keeps the reference's flat-index semantics
  (``window.py:140-143``): an event lands at ``slot * K + key`` of the
  flattened panes, so a key bucket outside ``[0, K)`` lands in a
  neighbouring slot's pane, as in the reference; the ``window_agg`` op
  keeps its TPU kernel's semantics (out-of-range keys add nothing).
* Every row reads its slot's occupant from the incoming ``slot_frame``, as
  in the reference, before any row's frame is recorded: the kernel merges
  the new frames in its last block (see ``csrc/window_agg.cu``).

Every state scalar stays int32, and ``//`` and ``%`` on int32 tensors
floor as ``jnp`` does, so frame ids, slots and window ends match the
reference bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .. import tracing
from ..kernels.window_agg import accumulate_, emit_

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
    """Jet stage 1, vectorized pane accumulation, in place: on a card one
    launch of the ``accumulate`` kernel, on the CPU its plain version
    (``kernels/window_agg.py``; the dispatch follows the state's device).

    ``wm_hint``: optional scalar watermark heartbeat (idle-source marker):
    advances event time without carrying data."""
    shape = (spec.ring_len, spec.n_key_buckets)
    if tuple(state["panes"].shape) != shape:
        raise ValueError(f"panes of shape {tuple(state['panes'].shape)}, "
                         f"the spec's are {shape}")
    with tracing.active().span("stream.accumulate"):
        return accumulate_(state, ts, key_bucket, value, valid,
                           slide_ms=spec.slide_ms,
                           frames_per_window=spec.frames_per_window,
                           wm_lag=spec.wm_lag,
                           frontier_from_data=spec.frontier_from_data,
                           wm_hint=wm_hint)


def emit(spec: VectorWindowSpec, state: Dict
         ) -> Tuple[Dict, Dict[str, object]]:
    """Jet stage 2, vectorized: emit window results with end <= watermark;
    evict the frame each emission retires (state updated in place).

    Returns ``(state, out)``.  ``out`` holds the reference's outputs
    (``results`` ``(EB, K)``, ``window_ends`` ``(EB,)``, ``valid``
    ``(EB,)``) and three host ints: ``rows`` (the valid rows are exactly
    the prefix ``[0, rows)``), ``rounds`` and ``host_syncs`` (1 on a
    card).  The active tracer (``tracing.active()``) gets a ``stream.emit``
    span around the call and a ``stream.emit.read`` span around each of the
    host syncs.
    """
    with tracing.active().span("stream.emit"):
        return emit_(state, slide_ms=spec.slide_ms,
                     frames_per_window=spec.frames_per_window,
                     max_windows_per_step=spec.max_windows_per_step,
                     buffer_rows=spec.emit_buffer_rows)


def step(spec: VectorWindowSpec, state: Dict, batch: Dict
         ) -> Tuple[Dict, Dict]:
    """One fused accumulate+emit step (the whole-DAG-per-chip tasklet)."""
    state = accumulate(spec, state, batch["ts"], batch["key"],
                       batch["value"], batch["valid"], batch.get("wm"))
    return emit(spec, state)
