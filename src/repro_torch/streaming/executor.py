"""StreamExecutor: the device-tier Jet runtime, single-device half, in PyTorch.

The port of ``repro/streaming/executor.py`` for ``mesh=None``: one step
ingests an event batch, accumulates it into the pane matrix (Jet stage 1,
the hand-written ``window_agg`` kernel) and emits every window the
watermark has closed (stage 2).  What the reference gets from ``jit``
the port gets from updating state in place (see ``window.py``); hence
``snapshot`` and ``restore`` return clones, never the live tensors.

Not ported yet (ROADMAP.md §1, queue item 1): SPMD execution over a mesh,
the ``"route"`` exchange, the ring-replicated snapshot and
``migrate_state``.
Asking for any of them raises; nothing quietly runs on one device instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..devices import resolve_device
from .window import VectorWindowSpec, step as window_step, window_state_init

ACK_INTERVAL_S = 0.1
WINDOW_FILL_FACTOR = 3

_NOT_PORTED = ("is not ported yet: the port runs the single-device executor "
               "only (ROADMAP.md §1, queue item 1: streaming/executor.py, "
               "multi-device half)")


@dataclasses.dataclass(frozen=True)
class StreamJobConfig:
    window: VectorWindowSpec
    batch_size: int = 4096          # events per step (global)
    snapshot_every: int = 0         # steps between snapshots (0 = off)
    #: keyed-exchange plan (SPMD only, which the port does not run yet):
    #: "reduce" (psum_scatter of full-width panes) or "route" (events
    #: all-to-all to their bucket owners); see the reference executor
    exchange: str = "reduce"


def _to_host_tensor(v) -> torch.Tensor:
    """A CPU tensor of ``v`` in the dtypes the reference's device arrays
    have: JAX's default 32-bit mode stores int64 as int32 and float64 as
    float32 on ``device_put``, and so does the port."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.require(v, requirements="C"))
    if t.dtype == torch.int64:
        t = t.to(torch.int32)
    elif t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t


class StreamExecutor:
    """Single-device executor: on ``cuda`` unless ``device`` says
    otherwise (``device="cpu"`` runs every kernel's plain version)."""

    #: device-held step outputs are copied to the host in chunks of this
    #: many steps, bounding live buffers without a per-step copy
    COLLECT_CHUNK = 64

    def __init__(self, cfg: StreamJobConfig, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(f"SPMD execution over a mesh "
                                      f"{_NOT_PORTED}")
        if cfg.exchange == "route":
            raise NotImplementedError(f'the "route" exchange {_NOT_PORTED}')
        self.device = resolve_device(device, "the executor")
        self.cfg = cfg
        # telemetry for the adaptive receive window
        self._processed_since_ack = 0
        self._last_ack = time.monotonic()
        self._receive_window = cfg.batch_size * WINDOW_FILL_FACTOR
        # emission-loop telemetry: rounds run and host syncs they cost
        self.emit_rounds = 0
        self.host_syncs = 0

    def init_state(self) -> Dict[str, torch.Tensor]:
        return window_state_init(self.cfg.window, device=self.device)

    # ------------------------------------------------------------- run --
    def step(self, state, batch, valid_count: Optional[int] = None):
        """One step on ``batch`` (tensors on this executor's device, e.g.
        from :meth:`stage_batch`); updates ``state`` in place and returns
        ``(state, out)``.  Pass ``valid_count`` (host-side event count,
        known at staging time) to spare the admission telemetry a sync."""
        if batch["ts"].device != self.device:
            raise ValueError(f"batch on {batch['ts'].device}, executor on "
                             f"{self.device}: stage it with stage_batch")
        state, out = window_step(self.cfg.window, state, batch)
        if valid_count is None:
            valid_count = int(batch["valid"].sum())
        self._processed_since_ack += valid_count
        self.emit_rounds += out["rounds"]
        self.host_syncs += out["host_syncs"]
        return state, out

    def stage_batch(self, batch: Dict) -> Tuple[Dict, int]:
        """Begin the host->device transfer of ``batch`` (numpy arrays or
        CPU tensors) without blocking.

        On ``cuda`` each field is copied from pinned host memory with
        ``non_blocking=True`` on the current stream (a field already pinned
        is not copied again on the host).  Returns ``(device_batch,
        valid_count)`` — the count is taken on the host *before* the
        transfer so the hot loop never syncs for it (the reference's
        executor.py:301-305 and :317).
        """
        count = int(np.asarray(batch["valid"]).sum())
        staged = {}
        for k, v in batch.items():
            if v is None:
                staged[k] = None
                continue
            t = _to_host_tensor(v)
            if self.device.type == "cuda":
                if not t.is_pinned():
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            staged[k] = t
        return staged, count

    def snapshot(self, state) -> Dict[str, torch.Tensor]:
        """A consistent copy of ``state`` (a step boundary).  The reference
        (executor.py:255-259) copies immutable arrays; here the live state
        changes in place, so the backup must be a clone or it would alias
        the state."""
        return {k: v.clone() for k, v in state.items()}

    def restore(self, backup) -> Dict[str, torch.Tensor]:
        """A live state from ``backup``; cloned, so running on it leaves
        the backup intact for a later restore."""
        return {k: v.clone() for k, v in backup.items()}

    # adaptive receive window (paper §3.3): how many events the source may
    # admit before the next ack
    def admissible(self) -> int:
        now = time.monotonic()
        if now - self._last_ack >= ACK_INTERVAL_S:
            rate = self._processed_since_ack
            if rate > 0:
                target = rate * WINDOW_FILL_FACTOR
                self._receive_window = max(
                    self.cfg.batch_size,
                    (self._receive_window + target) // 2)
            self._processed_since_ack = 0
            self._last_ack = now
        return self._receive_window

    # ------------------------------------------------------------ bench --
    def run_stream(self, event_gen: Callable[[int, int], Dict],
                   n_steps: int, collect: bool = True):
        """Drive ``n_steps`` steps; returns (state, results list).

        ``results`` holds ``(window_ends, rows)`` numpy pairs, one per step
        that emitted, as the reference's ``run_stream`` returns them.  Batch
        ``i+1`` is staged host->device before step ``i`` runs.  A step's
        valid rows (a prefix of its output buffer) are cut out on the
        device; only they are copied to the host, a chunk at a time — never
        the whole ``(EB, K)`` buffer the reference's ``_harvest`` converts
        (executor.py:367-373: 66 MB a step at the paper's configuration).
        """
        state = self.init_state()
        results: List[Tuple[np.ndarray, np.ndarray]] = []
        pending = []

        def _harvest():
            for ends, rows in pending:
                results.append((ends.cpu().numpy(), rows.cpu().numpy()))
            pending.clear()

        B = self.cfg.batch_size
        snap_every = self.cfg.snapshot_every
        nxt, nxt_count = self.stage_batch(event_gen(0, B))
        for i in range(n_steps):
            batch, count = nxt, nxt_count
            if i + 1 < n_steps:
                # pipelining: next batch's transfer is queued ahead of this
                # step's kernels
                nxt, nxt_count = self.stage_batch(event_gen((i + 1) * B, B))
            state, out = self.step(state, batch, valid_count=count)
            if snap_every and (i + 1) % snap_every == 0:
                self._last_backup = self.snapshot(state)
            n = out["rows"]
            if collect and n:
                pending.append((out["window_ends"][:n].clone(),
                                out["results"][:n].clone()))
                if len(pending) >= self.COLLECT_CHUNK:
                    _harvest()
        _harvest()
        return state, results
