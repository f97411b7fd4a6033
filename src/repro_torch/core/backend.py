"""Pluggable execution substrates for the Jet engine.

The engine core (:mod:`repro_torch.core.engine`) is substrate-agnostic:
it plans executions, owns job lifecycle and snapshot *policy*, and
delegates every "how does work actually run" decision to an
:class:`ExecutionBackend`.  Two backends ship:

* :class:`InProcessBackend` (default) — the paper-faithful cooperative
  model with every worker stepped by one driver thread.  All queues are
  in-process (:class:`~repro_torch.core.queues.SPSCQueue` locally,
  :class:`~repro_torch.core.backpressure.NetworkLink` across simulated nodes).
* :class:`~repro_torch.runtime.worker_proc.MultiprocessBackend` — each
  (node, cooperative-thread) pair becomes a real OS process; edges that
  cross a process boundary become shared-memory EventBlock rings
  (:class:`~repro_torch.core.shm_ring.ShmRing`).  It refuses jobs with
  a device-offloaded vertex, as the reference does.

The backend contract
====================

A backend is bound to one :class:`~repro_torch.core.engine.JetCluster` and is
consulted at four points of an execution's life:

**Build time** (inside ``ExecutionContext._build``):

* ``create_snapshot_context(job)`` returns the
  :class:`~repro_torch.core.tasklet.SnapshotContext` coordinating barrier/ack
  bookkeeping for one execution attempt.  The in-process context acks
  synchronously; the multiprocess one broadcasts begin/committed over
  control pipes and collects acks (plus snapshot entries) from workers.
* ``make_transport(execution, edge, src, dst)`` returns the queue-like
  object carrying items from producer location ``src`` to consumer
  location ``dst`` (each a ``(node_id, worker_slot)`` pair).  The object
  must satisfy the transport contract documented on
  :class:`~repro_torch.core.queues.SPSCQueue` (offer/offer_many/has_room_for/
  poll/peek/poll_prefix).
* ``assign_tasklet(execution, inst, tasklet)`` places a built tasklet on
  its worker (an in-process :class:`CooperativeWorker`, or a recorded
  (node, slot) -> process plan).

**Lifecycle**: ``start_execution`` runs after build *and after any
snapshot restore* (the multiprocess backend forks workers here, so
restored state is inherited by the children); ``stop_execution`` tears an
attempt down (remove tasklets from workers / terminate worker processes
and unlink rings).  Both must be idempotent.

**Driving**: ``step(jobs)`` performs one scheduler iteration of whatever
the backend owns (stepping cooperative workers and pumping links, or
draining worker control pipes) and returns whether progress was made;
``execution_done(execution)`` reports completion of the data plane.

**Snapshot fan-out**: ``notify_snapshot_committed(execution, sid)``
delivers the phase-2 commit signal to every processor's
``on_snapshot_committed`` hook wherever the processors actually live.

``clock_supported(clock)`` lets a backend veto clocks it cannot honor (a
:class:`~repro_torch.core.clock.VirtualClock` cannot tick across processes).

Failure semantics: cooperative vs detected
==========================================

Two distinct failure paths feed the engine's recovery machinery, and they
must not be conflated:

* **Cooperative failure** — an API call (``JetCluster.kill_node``,
  ``add_node``) scheduled by the operator/test.  The engine *initiates*
  the teardown, so every resource is released in order and the restart is
  immediate and unconditional (it does not consume the restart budget).
* **Detected failure** — the substrate notices, mid-flight, that part of
  the execution died without being asked to: a worker process SIGKILL'd
  by the OS (exitcode < 0), a hung worker (no heartbeat within the
  supervisor deadline), an error-exited worker (processor raised), or —
  in-process — a
  :class:`~repro_torch.core.tasklet.TaskletFailureError` out of a
  cooperative slice.  The backend converts the observation into
  :class:`WorkerFailure` records surfaced via :meth:`take_failures`;
  the engine's :class:`~repro_torch.core.engine.RestartPolicy` then decides
  between a bounded backoff restart (restore from the last *committed*
  snapshot) and the terminal ``FAILED`` status.

Abort vs commit: a snapshot whose barrier protocol is broken by a
detected failure (a worker dies holding an un-acked barrier, an ack
deadline lapses, a barrier broadcast hits a dead pipe) is **aborted** —
its buffered entries are discarded and the last committed snapshot stays
authoritative — never completed with partial state and never allowed to
stall the job waiting for an ack that cannot come.

``inject_fault(execution, kind, ...)`` is the seeded chaos layer's seam
(:mod:`repro_torch.runtime.chaos`): backends translate an abstract
fault kind ("kill", "stall", "raise", "drop_ack", "delay_ack") into the
most real failure they can produce (SIGKILL/SIGSTOP a worker process; plant an
exception inside a cooperative slice).  Returns False for kinds the
substrate cannot express, so schedules stay portable across backends.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .backpressure import NetworkLink
from .clock import Clock, VirtualClock
from .queues import SPSCQueue
from .tasklet import GUARANTEE_NONE, SnapshotContext, TaskletFailureError

Location = Tuple[int, int]      # (node_id, worker_slot)

#: WorkerFailure kinds
FAILURE_CRASHED = "crashed"     # process died on a signal (e.g. SIGKILL)
FAILURE_HUNG = "hung"           # no heartbeat within the deadline
FAILURE_ERROR = "error"         # processor raised / nonzero exit


class WorkerFailure:
    """One detected (uncooperative) failure, as classified by the
    substrate.  ``kind`` is one of :data:`FAILURE_CRASHED` /
    :data:`FAILURE_HUNG` / :data:`FAILURE_ERROR`; ``key`` locates the
    worker (``(node_id, worker_slot)``) where that is meaningful."""

    __slots__ = ("kind", "key", "detail", "exitcode", "pid", "vertex",
                 "exc_type", "poison")

    def __init__(self, kind: str, key: Optional[Location] = None,
                 detail: str = "", exitcode: Optional[int] = None,
                 pid: Optional[int] = None, vertex: Optional[str] = None,
                 exc_type: Optional[str] = None,
                 poison: Optional[dict] = None):
        self.kind = kind
        self.key = key
        self.detail = detail
        self.exitcode = exitcode
        self.pid = pid
        #: DAG vertex whose processor raised, when attributable — feeds
        #: failure fingerprinting (runtime/supervisor.py)
        self.vertex = vertex
        #: exception class name of the root cause, when attributable
        self.exc_type = exc_type
        #: exact offending record stamped by pinpoint replay
        #: (``ProcessorTasklet._process_pinpoint``): dict with
        #: vertex/identity/record/exact — the engine quarantines it to
        #: the dead-letter queue on fingerprint recurrence
        self.poison = poison

    def __repr__(self):
        return (f"WorkerFailure({self.kind}, key={self.key}, "
                f"pid={self.pid}, exitcode={self.exitcode}, "
                f"detail={self.detail[:80]!r})")


class ExecutionBackend:
    """Abstract execution substrate; see the module docstring for the
    contract.  Subclasses must be stateless across executions except for
    what they stash in ``execution.backend_data``."""

    name = "abstract"

    def __init__(self):
        self.cluster = None

    def bind(self, cluster) -> None:
        self.cluster = cluster

    def clock_supported(self, clock: Clock) -> bool:
        return True

    # -- build time ----------------------------------------------------------
    def create_snapshot_context(self, job) -> SnapshotContext:
        raise NotImplementedError

    def make_transport(self, execution, edge, src: Location,
                       dst: Location):
        raise NotImplementedError

    def assign_tasklet(self, execution, inst, tasklet) -> None:
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------------
    def start_execution(self, execution) -> None:
        raise NotImplementedError

    def stop_execution(self, execution) -> None:
        raise NotImplementedError

    # -- driving -------------------------------------------------------------
    def step(self, jobs) -> bool:
        raise NotImplementedError

    def execution_done(self, execution) -> bool:
        raise NotImplementedError

    def notify_snapshot_committed(self, execution, snapshot_id: int) -> None:
        raise NotImplementedError

    # -- failure detection ---------------------------------------------------
    def take_failures(self, execution) -> List[WorkerFailure]:
        """Detected failures since the last call (drained; each failure is
        reported exactly once).  The engine consults this every driver
        iteration and routes non-empty results into the job's restart
        policy."""
        if execution is None:
            return []
        failures = execution.backend_data.get("failures")
        if not failures:
            return []
        execution.backend_data["failures"] = []
        return failures

    def inject_fault(self, execution, kind: str, worker_index: int = 0,
                     **params) -> bool:
        """Chaos seam: inject one fault of ``kind`` into a live execution.
        Returns True if the substrate could express the fault (see module
        docstring)."""
        return False

    def shutdown(self) -> None:
        """Release any cluster-wide resources (idempotent)."""


class InProcessBackend(ExecutionBackend):
    """The default cooperative substrate: every tasklet of every node runs
    on this thread, stepped round-robin; cross-node edges are simulated
    :class:`NetworkLink`s pumped once per scheduler iteration.  This is
    byte-for-byte the seed engine's behavior, factored behind the backend
    contract."""

    name = "inproc"

    def create_snapshot_context(self, job) -> SnapshotContext:
        writer = (self.cluster.snapshot_store.writer(job.id)
                  if job.config.processing_guarantee != GUARANTEE_NONE
                  else None)
        return SnapshotContext(job.config.processing_guarantee, writer)

    def make_transport(self, execution, edge, src: Location, dst: Location):
        if src[0] == dst[0]:
            return SPSCQueue(edge.queue_size)
        link = NetworkLink(self.cluster.clock,
                           latency_s=self.cluster.link_latency_s,
                           recv_capacity=edge.queue_size)
        execution.links.append(link)
        return link

    def assign_tasklet(self, execution, inst, tasklet) -> None:
        cluster = self.cluster
        worker = cluster.nodes[inst.node].workers[
            inst.local_index % cluster.cooperative_threads]
        worker.add(tasklet)

    def start_execution(self, execution) -> None:
        pass    # tasklets were placed on live workers at build time

    def stop_execution(self, execution) -> None:
        dead = set(map(id, execution.tasklets))
        for node in self.cluster.nodes.values():
            for w in node.workers:
                w.tasklets = [t for t in w.tasklets if id(t) not in dead]

    def step(self, jobs) -> bool:
        progress = False
        for node in self.cluster.nodes.values():
            for worker in node.workers:
                try:
                    progress |= worker.run_iteration()
                except TaskletFailureError as tf:
                    # detected (uncooperative) failure on the in-process
                    # substrate: route it into the owning job's failure
                    # queue instead of crashing the driver; the engine's
                    # restart policy takes it from there
                    self._record_tasklet_failure(jobs, tf)
                    progress = True
        for job in jobs:
            if job.execution is not None:
                for link in job.execution.links:
                    progress |= link.pump()
        return progress

    @staticmethod
    def _record_tasklet_failure(jobs, tf: TaskletFailureError) -> None:
        for job in jobs:
            execution = job.execution
            if execution is not None and any(t is tf.tasklet
                                             for t in execution.tasklets):
                execution.backend_data.setdefault("failures", []).append(
                    WorkerFailure(FAILURE_ERROR,
                                  detail=f"{tf.tasklet.name}: "
                                         f"{tf.cause!r}",
                                  vertex=tf.tasklet.vertex_name,
                                  exc_type=type(tf.cause).__name__,
                                  poison=getattr(tf.cause, "_jet_poison",
                                                 None)))
                return
        # no owning execution (already torn down): nothing to heal
        raise tf

    def inject_fault(self, execution, kind: str, worker_index: int = 0,
                     **params) -> bool:
        """In-process chaos: "kill" and "raise" both plant an exception in
        a deterministic live tasklet (there is no process to SIGKILL; an
        exception out of a cooperative slice IS this substrate's
        uncooperative failure).  Ring/ack faults have no in-process
        equivalent and report unsupported."""
        if kind not in ("kill", "raise"):
            return False
        live = sorted((t for t in execution.tasklets if not t.is_done),
                      key=lambda t: t.name)
        if not live:
            return False
        target = live[worker_index % len(live)]
        target._chaos_exc = RuntimeError(
            params.get("message", f"chaos[{kind}] injected"))
        return True

    def execution_done(self, execution) -> bool:
        return all(t.is_done for t in execution.tasklets)

    def notify_snapshot_committed(self, execution, snapshot_id: int) -> None:
        for t in execution.tasklets:
            hook = getattr(t.processor, "on_snapshot_committed", None)
            if hook is not None:
                hook(snapshot_id)


def make_backend(spec) -> ExecutionBackend:
    """Resolve a backend from its registry name (``"inproc"``/``"mp"``) or
    pass an already-constructed :class:`ExecutionBackend` through."""
    if isinstance(spec, ExecutionBackend):
        return spec
    if spec in (None, "inproc"):
        return InProcessBackend()
    if spec == "mp":
        from ..runtime.worker_proc import MultiprocessBackend
        return MultiprocessBackend()
    raise ValueError(f"unknown execution backend {spec!r} "
                     "(expected 'inproc', 'mp', or an ExecutionBackend)")
