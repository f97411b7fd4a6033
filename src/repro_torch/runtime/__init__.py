"""Training and serving runtime: the optimizer (``optimizer.AdamW``), the
replayable data source (``data.py``), checkpointing (``checkpoint.py``)
and gradient compression (``compression.py``), as in the reference; and
the host engine's runtime services, copies of
``repro/runtime/{supervisor,worker_proc,chaos}.py``.  The engine takes
``failure_fingerprint`` from ``supervisor.py``; ``worker_proc.py`` is the
multiprocess backend (``backend="mp"``) the supervisor watches;
``chaos.py`` injects seeded faults.  The package exports ``AdamW``, as the
reference's does, and the supervisor's names."""

from .optimizer import AdamW
from .supervisor import (DEFAULT_HEARTBEAT_TIMEOUT_S, WorkerSupervisor,
                         failure_fingerprint)

__all__ = ["AdamW", "DEFAULT_HEARTBEAT_TIMEOUT_S", "WorkerSupervisor",
           "failure_fingerprint"]
