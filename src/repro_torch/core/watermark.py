"""Event-time watermarks: generation policy and multi-input coalescing.

Jet sources stamp watermarks according to an out-of-orderness allowance;
multi-input vertices coalesce per-queue watermarks by taking the minimum
(an edge's watermark asserts "no later item on THIS edge is earlier").
"""

from __future__ import annotations

from typing import Dict, Optional

from .events import MIN_TIME


class EventTimePolicy:
    """Bounded out-of-orderness watermark generation with throttling.

    ``lag``            — max allowed event-time disorder.
    ``min_step``       — don't emit a watermark unless it advanced this much
                         (throttling; Jet default granularity is 10-50 ms
                         worth of event time for low-latency jobs).
    ``idle_timeout``   — after this much wall time without events, mark the
                         source idle so it stops holding back the coalesced
                         watermark downstream.
    """

    __slots__ = ("lag", "min_step", "idle_timeout", "_top_ts", "_last_wm")

    def __init__(self, lag: int = 0, min_step: int = 1,
                 idle_timeout: Optional[float] = None):
        self.lag = lag
        self.min_step = min_step
        self.idle_timeout = idle_timeout
        self._top_ts = MIN_TIME
        self._last_wm = MIN_TIME

    def observe(self, ts: int) -> Optional[int]:
        """Record an event timestamp; return a new watermark ts or None."""
        if ts > self._top_ts:
            self._top_ts = ts
            wm = ts - self.lag
            if wm >= self._last_wm + self.min_step:
                self._last_wm = wm
                return wm
        return None

    @property
    def current(self) -> int:
        return self._last_wm


class WatermarkCoalescer:
    """Min-coalescing of watermarks across input queues.

    Tracks the last watermark seen on each queue; the coalesced output only
    advances when the *minimum* across all live queues advances.  Queues that
    reported DONE or idle are excluded.
    """

    __slots__ = ("_queue_wm", "_live", "_coalesced")

    def __init__(self, n_queues: int):
        self._queue_wm = [MIN_TIME] * n_queues
        self._live = [True] * n_queues
        self._coalesced = MIN_TIME

    def observe(self, queue_index: int, wm_ts: int) -> Optional[int]:
        """Record watermark from one queue; return new coalesced ts or None."""
        if wm_ts > self._queue_wm[queue_index]:
            self._queue_wm[queue_index] = wm_ts
        return self._recompute()

    def queue_done(self, queue_index: int) -> Optional[int]:
        self._live[queue_index] = False
        return self._recompute()

    def _recompute(self) -> Optional[int]:
        live_wms = [wm for wm, live in zip(self._queue_wm, self._live) if live]
        if not live_wms:
            return None
        new = min(live_wms)
        if new > self._coalesced:
            self._coalesced = new
            return new
        return None

    @property
    def coalesced(self) -> int:
        return self._coalesced
