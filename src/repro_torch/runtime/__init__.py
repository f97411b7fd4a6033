"""Runtime services of the host engine: copies of
``repro/runtime/{supervisor,worker_proc,chaos}.py``.  The engine takes
``failure_fingerprint`` from ``supervisor.py``; ``worker_proc.py`` is the
multiprocess backend (``backend="mp"``) the supervisor watches;
``chaos.py`` injects seeded faults.  The reference's package exports its
optimizer, which the port has not ported (ROADMAP.md §1, queue item 5),
so this package exports the supervisor's names."""

from .supervisor import (DEFAULT_HEARTBEAT_TIMEOUT_S, WorkerSupervisor,
                         failure_fingerprint)

__all__ = ["DEFAULT_HEARTBEAT_TIMEOUT_S", "WorkerSupervisor",
           "failure_fingerprint"]
