"""Runtime services of the host engine.  Only ``supervisor.py`` is ported
so far (a copy of ``repro/runtime/supervisor.py``): the engine takes
``failure_fingerprint`` from it.  The multiprocess workers it watches
(``runtime/worker_proc.py``) are ROADMAP.md §1, queue item 7."""

from .supervisor import (DEFAULT_HEARTBEAT_TIMEOUT_S, WorkerSupervisor,
                         failure_fingerprint)

__all__ = ["DEFAULT_HEARTBEAT_TIMEOUT_S", "WorkerSupervisor",
           "failure_fingerprint"]
