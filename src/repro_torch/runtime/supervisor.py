"""Coordinator-side worker supervision: detecting failures the engine
did not schedule.

:class:`WorkerSupervisor` watches one execution attempt's worker
processes (``runtime/worker_proc.py``) through two independent signals
and classifies every uncooperative death:

* **exitcodes** — a worker process that is gone without having reported
  its data plane DONE is abnormal.  A negative exitcode means the OS
  delivered a fatal signal (SIGKILL'd mid-run -> :data:`FAILURE_CRASHED`);
  a non-negative one means the interpreter exited on its own, i.e. a
  processor raised (:data:`FAILURE_ERROR` — usually preceded by the
  child's ``("error", traceback)`` message, which carries the detail).
* **heartbeats** — children send a tiny ``("hb",)`` record on their
  control pipe every :data:`~repro_torch.runtime.worker_proc._HEARTBEAT_S`
  seconds, even while parked idle or blocked post-DONE.  A live process
  whose heartbeat is older than ``heartbeat_timeout_s`` is **hung**
  (wedged in a slice, SIGSTOP'd, deadlocked on a ring): the supervisor
  SIGKILLs it — a hung worker holds ring slots and barrier alignment
  hostage, so it must die before recovery can run — and reports
  :data:`FAILURE_HUNG`.

The supervisor never decides *policy*: it only produces
:class:`~repro_torch.core.backend.WorkerFailure` records, which the backend
surfaces through ``take_failures`` and the engine routes into the job's
:class:`~repro_torch.core.engine.RestartPolicy` (bounded backoff restarts from
the last committed snapshot, then terminal FAILED).

Each failure is reported exactly once per worker; a worker that already
delivered its DONE is exempt (its exit is expected at teardown).
"""

from __future__ import annotations

import os
import signal
import time as _time
from typing import Dict, Iterable, List, Optional

from ..core.backend import (FAILURE_CRASHED, FAILURE_ERROR, FAILURE_HUNG,
                            Location, WorkerFailure)

#: default heartbeat deadline — generous next to the ~4/s child cadence so
#: scheduler hiccups on a loaded box never read as failures
DEFAULT_HEARTBEAT_TIMEOUT_S = 5.0


def failure_fingerprint(failure: WorkerFailure, restored_snapshot_id):
    """Identity of a detected failure for crash-loop escalation.

    ``(vertex, exception type, restored snapshot id)`` when the failure
    is attributable to a processor raise; the worker location and failure
    kind otherwise.  Keying on the *restored* snapshot id is what makes
    the fingerprint mean "deterministic": the same vertex raising the
    same exception twice after restoring the same epoch is replaying an
    identical crash, and the engine escalates (fall back a chain entry /
    quarantine the stamped poison record) instead of burning the restart
    budget on it.  See ``Job._note_failures`` in core/engine.py."""
    return (failure.vertex or failure.key,
            failure.exc_type or failure.kind,
            restored_snapshot_id)


class WorkerSupervisor:
    """Watches the worker processes of one execution attempt."""

    __slots__ = ("heartbeat_timeout_s", "_last_hb", "_reported")

    def __init__(self,
                 heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S):
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._last_hb: Dict[Location, float] = {}
        self._reported: set = set()

    # -- signal intake -------------------------------------------------------
    def worker_started(self, key: Location,
                       now: Optional[float] = None) -> None:
        """Arm the heartbeat deadline at fork time, so a worker that wedges
        before its first heartbeat is still caught."""
        self._last_hb[key] = _time.monotonic() if now is None else now

    def heartbeat(self, key: Location, now: Optional[float] = None) -> None:
        self._last_hb[key] = _time.monotonic() if now is None else now

    def mark_reported(self, key: Location) -> None:
        """Suppress double-reporting for a failure classified elsewhere
        (e.g. the drain loop saw the child's ``("error", tb)`` message and
        recorded it with the full traceback)."""
        self._reported.add(key)

    # -- classification ------------------------------------------------------
    def check(self, handles: Iterable,
              now: Optional[float] = None) -> List[WorkerFailure]:
        """Classify every not-yet-reported abnormal worker among
        ``handles`` (``_WorkerHandle``-shaped: key/proc/done attributes).
        Hung workers are SIGKILLed as a side effect."""
        if now is None:
            now = _time.monotonic()
        failures: List[WorkerFailure] = []
        for h in handles:
            if h.done or h.key in self._reported:
                continue
            code = h.proc.exitcode
            if code is not None:
                self._reported.add(h.key)
                if code < 0:
                    failures.append(WorkerFailure(
                        FAILURE_CRASHED, key=h.key, exitcode=code,
                        pid=h.proc.pid,
                        detail=f"worker n{h.key[0]}-w{h.key[1]} killed by "
                               f"signal {-code} without reporting DONE"))
                else:
                    failures.append(WorkerFailure(
                        FAILURE_ERROR, key=h.key, exitcode=code,
                        pid=h.proc.pid,
                        detail=f"worker n{h.key[0]}-w{h.key[1]} exited "
                               f"with code {code} without reporting DONE"))
                continue
            last = self._last_hb.get(h.key)
            if (last is not None
                    and now - last > self.heartbeat_timeout_s):
                self._reported.add(h.key)
                # a hung worker still owns ring cursors and an un-acked
                # barrier; it cannot be left running while the job
                # restarts around it
                try:
                    os.kill(h.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, OSError):  # pragma: no cover
                    pass
                failures.append(WorkerFailure(
                    FAILURE_HUNG, key=h.key, pid=h.proc.pid,
                    detail=f"worker n{h.key[0]}-w{h.key[1]}: no heartbeat "
                           f"for {now - last:.2f}s "
                           f"(deadline {self.heartbeat_timeout_s}s); "
                           f"SIGKILLed"))
        return failures
