"""Clock abstraction: wall clock for real benchmarks, virtual clock for
deterministic tests and calibrated scale-out simulation."""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError


class WallClock(Clock):
    __slots__ = ()

    def now(self) -> float:
        return time.monotonic()


class VirtualClock(Clock):
    """Manually advanced clock; the engine advances it when idle so that
    time-driven behaviour (snapshot intervals, ack cadence, pacing sources)
    runs deterministically and faster than real time."""

    __slots__ = ("_t", "auto_step")

    def __init__(self, start: float = 0.0, auto_step: float = 1e-4):
        self._t = start
        #: seconds added per idle engine iteration
        self.auto_step = auto_step

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += dt
