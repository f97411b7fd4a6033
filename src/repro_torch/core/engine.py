"""The Jet cluster engine: execution planning, cooperative scheduling,
snapshot coordination, failure recovery and elasticity.

Execution planning follows the paper exactly (§3.1, Fig. 3): every vertex is
instantiated ``local_parallelism`` times on **every** node, with the default
parallelism equal to the node's cooperative thread count so that *each worker
runs the complete DAG*.  Edges become SPSC queues locally and
:class:`~repro_torch.core.backpressure.NetworkLink`s across nodes.  Keyed edges
route by ``hash(key) % PARTITION_COUNT``; the partition table that assigns
those partitions to nodes is the *same* table the IMap state backend uses —
Jet's "partitioning of IMDG aligns with partitioning of the execution
engine" invariant.

How the planned execution actually runs is delegated to a pluggable
:class:`~repro_torch.core.backend.ExecutionBackend` (see that module for the
contract).  The default ``backend="inproc"`` drives the whole cluster
cooperatively from :meth:`JetCluster.step` on the calling thread — the
paper's model with every simulated core multiplexed onto one real one.
``backend="mp"`` runs each (node, cooperative-thread) pair as a real OS
process with shared-memory EventBlock rings between them
(:mod:`repro_torch.runtime.worker_proc`), so the cooperative model maps
onto as many cores as the machine offers; it refuses device-offloaded
vertices.
"""

from __future__ import annotations

import itertools
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..state import DurableSnapshotStore, IMapService, SnapshotStore
from .backend import ExecutionBackend, InProcessBackend, make_backend
from .backpressure import NetworkLink
from .clock import Clock, VirtualClock, WallClock
from .dag import DAG, Edge, PARTITION_COUNT, Routing, Vertex
from .events import MAX_TIME
from .processor import ProcessorContext
from .tasklet import (CooperativeWorker, EdgeCollector, InQueue,
                      GUARANTEE_EXACTLY_ONCE, GUARANTEE_NONE,
                      ProcessorTasklet, SnapshotContext)

JOB_RUNNING = "running"
JOB_COMPLETED = "completed"
JOB_FAILED = "failed"
JOB_RESTARTING = "restarting"


class JobFailedError(RuntimeError):
    """A job reached the terminal FAILED status (restart budget exhausted,
    or a detected failure with no snapshot guarantee to restore from)."""

    def __init__(self, job):
        self.job = job
        self.failures = list(job.failures)
        last = self.failures[-1] if self.failures else None
        super().__init__(
            f"job {job.id} FAILED after {job.auto_restarts} automatic "
            f"restart(s); last failure: {last!r}")


class RestartPolicy:
    """Bounded self-healing for *detected* failures (paper §4.4 recovery,
    made automatic): each detected worker death/hang/error triggers
    teardown -> restore-from-committed-snapshot -> restart, delayed by
    exponential backoff, at most ``max_restarts`` times before the job
    transitions to the terminal FAILED status.  Cooperative restarts
    (``kill_node`` / ``add_node``) do not consume this budget — the
    operator asked for those."""

    def __init__(self, max_restarts: int = 5, backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 fingerprint_threshold: int = 2):
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        #: a failure fingerprint (vertex, exception type, restored
        #: snapshot id) recurring this many times marks the crash
        #: deterministic and escalates (snapshot-chain fallback /
        #: poison-record quarantine) instead of replaying it identically
        self.fingerprint_threshold = max(1, fingerprint_threshold)

    def delay_for(self, attempt: int) -> float:
        """Backoff before restart ``attempt`` (1-based): base * 2^(n-1),
        capped."""
        return min(self.backoff_base_s * (2 ** max(attempt - 1, 0)),
                   self.backoff_max_s)

# progressive idle backoff (paper §3.2: spin -> yield -> park).  An idle
# scheduler first busy-spins (lowest wake-up latency), then yields its
# timeslice, then parks in escalating naps so an idle job stops burning
# the core.  The park ceiling bounds the extra latency a waking event can
# observe, keeping the tail budget in check.
IDLE_SPIN_ITERS = 64
IDLE_YIELD_ITERS = 192
IDLE_PARK_MIN_S = 0.00005
IDLE_PARK_MAX_S = 0.0002


class JobConfig:
    def __init__(self, name: str = "job",
                 processing_guarantee: str = GUARANTEE_NONE,
                 snapshot_interval_s: float = 1.0,
                 restart_policy: Optional[RestartPolicy] = None,
                 barrier_timeout_s: float = 5.0):
        self.name = name
        self.processing_guarantee = processing_guarantee
        self.snapshot_interval_s = snapshot_interval_s
        self.restart_policy = restart_policy or RestartPolicy()
        #: a snapshot whose barrier acks have not all arrived within this
        #: deadline is ABORTED (entries discarded, last committed snapshot
        #: stays authoritative) instead of stalling the job forever; only
        #: meaningful on substrates whose acks can actually be lost (mp)
        self.barrier_timeout_s = barrier_timeout_s


class DeadLetterQueue:
    """Coordinator-side dead-letter sink with exactly-once accounting.

    A record lands here at most once (identity-deduplicated per vertex)
    when the escalation ladder proves it poison: the same vertex raised
    the same exception from the same restored snapshot
    ``RestartPolicy.fingerprint_threshold`` times, and a pinpoint replay
    stamped the exact in-flight record onto the failure.  After
    quarantine, every execution attempt filters the record out before
    the processor sees it (``ProcessorTasklet._drop_quarantined``), so
    the surviving stream keeps its zero-dup/zero-loss guarantee while
    the poison record is accounted for exactly once — here."""

    def __init__(self):
        #: chronological quarantine records
        #: ({vertex, identity, record, reason})
        self.records: List[Dict[str, Any]] = []
        self._by_vertex: Dict[str, set] = {}

    def quarantine(self, vertex: str, identity, record: str,
                   reason: str = "") -> bool:
        """Add one record; False when it was already quarantined."""
        ids = self._by_vertex.setdefault(vertex, set())
        if identity in ids:
            return False
        ids.add(identity)
        self.records.append({"vertex": vertex, "identity": identity,
                             "record": record, "reason": reason})
        return True

    def identities_for(self, vertex: str):
        return self._by_vertex.get(vertex)

    def __len__(self):
        return len(self.records)

    def summary(self) -> List[Dict[str, str]]:
        return [{"vertex": r["vertex"], "record": r["record"],
                 "reason": r["reason"]} for r in self.records]


class _Instance:
    """One deployed processor instance (vertex x node x local index)."""

    __slots__ = ("vertex", "node", "local_index", "global_index", "tasklet")

    def __init__(self, vertex: str, node: int, local_index: int,
                 global_index: int):
        self.vertex = vertex
        self.node = node
        self.local_index = local_index
        self.global_index = global_index
        self.tasklet: Optional[ProcessorTasklet] = None


class ExecutionContext:
    """One execution attempt of a job on a concrete topology."""

    def __init__(self, job: "Job", cluster: "JetCluster"):
        self.job = job
        self.cluster = cluster
        self.instances: Dict[str, List[_Instance]] = {}
        self.tasklets: List[ProcessorTasklet] = []
        self.links: List[NetworkLink] = []
        self.ssctx: Optional[SnapshotContext] = None
        #: backend-private per-execution state (worker plans, ring registry,
        #: control pipes, ... — opaque to the engine core)
        self.backend_data: Dict[str, Any] = {}
        self._build()

    # ------------------------------------------------------------------ build --
    def _build(self) -> None:
        cluster, job = self.cluster, self.job
        dag = job.dag
        dag.validate()
        nodes = sorted(cluster.node_ids)
        n_nodes = len(nodes)
        table = cluster.imap_service.table

        self.ssctx = cluster.backend.create_snapshot_context(job)

        # 1. instantiate vertices
        lp_of: Dict[str, int] = {}
        for name, v in dag.vertices.items():
            lp = v.local_parallelism if v.local_parallelism > 0 \
                else cluster.cooperative_threads
            lp_of[name] = lp
            insts = []
            for ni, node in enumerate(nodes):
                for li in range(lp):
                    insts.append(_Instance(name, node, li, ni * lp + li))
            self.instances[name] = insts

        # 2. create queues per edge: consumer-side InQueues and
        #    producer-side collectors
        in_queues: Dict[Tuple[str, int, int], List[InQueue]] = {}
        collectors: Dict[Tuple[str, int, int], List[EdgeCollector]] = {}
        for key in itertools.chain.from_iterable(
                ((v, inst.node, inst.local_index) for inst in insts)
                for v, insts in self.instances.items()):
            in_queues[key] = []
            collectors[key] = []

        for edge in dag.edges:
            self._wire_edge(edge, lp_of, nodes, table, in_queues, collectors)

        # 3. build tasklets and assign to workers
        snapshot_interval_ok = job.config.processing_guarantee != GUARANTEE_NONE
        for name, insts in self.instances.items():
            vertex = dag.vertices[name]
            lp = lp_of[name]
            in_edges = dag.in_edges(name)
            for inst in insts:
                processor = vertex.supplier()
                owned = tuple(
                    p for p in range(table.partition_count)
                    if table.owner(p) == inst.node and p % lp == inst.local_index)
                ctx = ProcessorContext(
                    vertex_name=name, global_index=inst.global_index,
                    local_index=inst.local_index,
                    total_parallelism=lp * n_nodes, node_id=inst.node,
                    node_count=n_nodes, partition_ids=owned,
                    partition_count=table.partition_count,
                    clock=cluster.clock)
                key = (name, inst.node, inst.local_index)
                spf = getattr(processor, "snapshot_partition", None)
                tasklet = ProcessorTasklet(
                    name=f"{name}#{inst.global_index}", processor=processor,
                    in_queues=in_queues[key], collectors=collectors[key],
                    ssctx=self.ssctx, vertex_name=name,
                    global_index=inst.global_index,
                    snapshot_pid_fn=spf,
                    is_source=not in_edges,
                    # dead-letter filtering + pinpoint replay for vertices
                    # the escalation ladder flagged (see DeadLetterQueue)
                    poison_ids=job.dead_letters.identities_for(name),
                    pinpoint=name in job.suspect_vertices)
                processor.init(tasklet.outbox, ctx)
                inst.tasklet = tasklet
                self.tasklets.append(tasklet)
                cluster.backend.assign_tasklet(self, inst, tasklet)
        self.ssctx.tasklets = self.tasklets
        self.ssctx.on_complete = self.job._on_snapshot_complete

        # columnar emission is only a win when blocks survive past the
        # source: a fused chain without a vectorized form, or immediate
        # consumers none of whom accept blocks, would explode every block
        # straight back to events — paying vectorized generation PLUS the
        # per-row scalar materialization.  Downgrade auto-mode sources on
        # such topologies to the scalar path (an EXPLICIT block_size is
        # honored as given).
        for name, insts in self.instances.items():
            if dag.in_edges(name) or not dag.out_edges(name):
                continue
            dst_accepts = any(
                getattr(self.instances[e.dst][0].tasklet.processor,
                        "accepts_blocks", False)
                for e in dag.out_edges(name))
            for inst in insts:
                p = inst.tasklet.processor
                inner = getattr(p, "inner", p)
                if getattr(inner, "block_size", 0) is not None:
                    continue        # scalar-forced, explicit, or no knob
                chain_explodes = (hasattr(p, "_chain_blk")
                                  and p._chain_blk is None)
                if chain_explodes or not dst_accepts:
                    inner.block_size = 0

    def _wire_edge(self, edge: Edge, lp_of: Dict[str, int],
                   nodes: List[int], table,
                   in_queues, collectors) -> None:
        lp_src, lp_dst = lp_of[edge.src], lp_of[edge.dst]
        consumers: List[Tuple[int, int]] = []   # (node, local_index)
        if edge.routing == Routing.ISOLATED and not edge.distributed:
            if lp_src != lp_dst:
                raise ValueError(
                    f"isolated edge {edge} needs equal parallelism")
        # producer instance -> its queue targets
        for src_inst in self.instances[edge.src]:
            queues = []
            dests: List[Tuple[int, int]] = []
            if edge.routing == Routing.ISOLATED and not edge.distributed:
                dests = [(src_inst.node, src_inst.local_index)]
            elif edge.distributed:
                dests = [(n, li) for n in nodes for li in range(lp_dst)]
            else:
                dests = [(src_inst.node, li) for li in range(lp_dst)]
            threads = self.cluster.cooperative_threads
            src_loc = (src_inst.node, src_inst.local_index % threads)
            for (n, li) in dests:
                q = self.cluster.backend.make_transport(
                    self, edge, src_loc, (n, li % threads))
                queues.append(q)
                in_queues[(edge.dst, n, li)].append(
                    InQueue(q, edge.dst_ordinal, priority=edge.priority))
            p2q = None
            if edge.routing == Routing.PARTITIONED:
                p2q = [0] * PARTITION_COUNT
                for pid in range(PARTITION_COUNT):
                    if edge.distributed:
                        owner = table.owner(pid % table.partition_count)
                        dest = (owner, pid % lp_dst)
                    else:
                        dest = (src_inst.node, pid % lp_dst)
                    p2q[pid] = dests.index(dest)
            collectors[(edge.src, src_inst.node, src_inst.local_index)].append(
                EdgeCollector(queues, edge.routing, edge.key_fn, p2q))

    # -------------------------------------------------------------- restore --
    def restore_from_snapshot(self, snapshot_id: int) -> int:
        """Load processor state from a committed snapshot. Returns the
        number of restored entries."""
        store = self.cluster.snapshot_store
        table = self.cluster.imap_service.table
        count = 0
        # group entries by (vertex, owning instance under the new topology)
        for name, insts in self.instances.items():
            lp = max(1, len(insts) // max(1, len(self.cluster.node_ids)))
            by_instance: Dict[Tuple[int, int], List[Tuple[Any, Any]]] = {}
            for pid in range(table.partition_count):
                entries = store.entries_for_partition(self.job.id, snapshot_id,
                                                      pid)
                for vertex, key, value in entries:
                    if vertex != name:
                        continue
                    dest = (table.owner(pid), pid % lp)
                    by_instance.setdefault(dest, []).append((key, value))
                    count += 1
            for inst in insts:
                items = by_instance.get((inst.node, inst.local_index))
                if items:
                    inst.tasklet.processor.restore_from_snapshot(items)
            for inst in insts:
                inst.tasklet.processor.finish_snapshot_restore()
                inst.tasklet.last_snapshot_id = snapshot_id
        self.ssctx.requested_id = snapshot_id
        self.ssctx.completed_id = snapshot_id
        return count

    @property
    def all_done(self) -> bool:
        return self.cluster.backend.execution_done(self)

    def stats(self) -> Dict[str, Any]:
        return {
            "tasklets": len(self.tasklets),
            "links": len(self.links),
            "items_in": sum(t.items_in for t in self.tasklets),
            "items_out": sum(t.items_out for t in self.tasklets),
            "calls": sum(t.calls for t in self.tasklets),
            "idle_calls": sum(t.idle_calls for t in self.tasklets),
        }


class Job:
    _ids = itertools.count()

    def __init__(self, cluster: "JetCluster", dag: DAG, config: JobConfig,
                 job_id: Optional[str] = None):
        self.cluster = cluster
        self.dag = dag
        self.config = config
        # an explicit id is the cold-start adoption path
        # (JetCluster.recover_job): the job must keep the identity under
        # which its durable snapshot chain was written
        self.id = job_id or f"{config.name}-{next(Job._ids)}"
        self.status = JOB_RUNNING
        self.execution: Optional[ExecutionContext] = None
        self._next_snapshot_id = 1
        self._last_snapshot_at = cluster.clock.now()
        self.snapshots_taken = 0
        self.restarts = 0
        #: automatic restarts consumed by DETECTED failures (bounded by
        #: ``config.restart_policy``; cooperative restarts not included)
        self.auto_restarts = 0
        #: detected-failure history (WorkerFailure records)
        self.failures: List[Any] = []
        #: cluster-clock instant the pending self-heal restart is due
        self._restart_due_at: Optional[float] = None
        #: aborted-snapshot tally of already-discarded executions
        self._aborted_before = 0
        # -- crash-loop escalation state (see _note_failures) ------------
        #: quarantined poison records, exactly-once accounting
        self.dead_letters = DeadLetterQueue()
        #: vertices with an attributed failure whose poison record is not
        #: yet known; rebuilt executions run them in pinpoint mode
        self.suspect_vertices: set = set()
        #: failure fingerprint -> recurrence count
        self._fp_counts: Dict[Any, int] = {}
        #: chain entries to skip ahead of verification (bumped on
        #: fingerprint recurrence: the newest snapshots replay a
        #: deterministic crash); reset when a fresh snapshot commits
        self._fallback_depth = 0
        #: snapshot id the current execution was restored from (None for
        #: a fresh build) — the epoch component of failure fingerprints
        self._restored_sid: Optional[int] = None
        #: chronological restore/escalation record, the recovery
        #: diagnostic surfaced in job stats and bench_chaos reports
        self.recovery_log: List[Dict[str, Any]] = []

    # -- snapshot coordination ----------------------------------------------------
    def tick(self, now: float) -> None:
        if (self.status != JOB_RUNNING
                or self.config.processing_guarantee == GUARANTEE_NONE):
            return
        ssctx = self.execution.ssctx
        if ssctx.check_timeout():
            # in-flight snapshot aborted (overdue barrier acks): give the
            # next attempt a full interval rather than retrying instantly
            self._last_snapshot_at = now
            return
        if (now - self._last_snapshot_at >= self.config.snapshot_interval_s
                and ssctx.completed_id == ssctx.requested_id):
            ssctx.begin(self._next_snapshot_id)
            self._next_snapshot_id += 1
            self._last_snapshot_at = now

    @property
    def snapshots_aborted(self) -> int:
        """Snapshots abandoned without commit across all execution
        attempts of this job (ack timeouts, worker death mid-barrier)."""
        aborted = self._aborted_before
        if self.execution is not None and self.execution.ssctx is not None:
            aborted += self.execution.ssctx.aborted_count
        return aborted

    # -- detected failures / self-healing -----------------------------------------
    def on_detected_failure(self, failures) -> None:
        """Route detected (uncooperative) failures into the restart
        policy: tear the half-dead execution down, then either schedule a
        backoff restart from the last committed snapshot or transition to
        the terminal FAILED status."""
        if self.status in (JOB_COMPLETED, JOB_FAILED):
            return
        self.failures.extend(failures)
        self._note_failures(failures)
        if self.execution is not None:
            # stop the attempt NOW: surviving workers must not keep
            # producing into a topology that is about to be discarded
            self.cluster.backend.stop_execution(self.execution)
            if self.execution.ssctx is not None:
                # retire the storage of any snapshot caught mid-barrier:
                # it can never commit and would otherwise leak its IMap
                self.execution.ssctx.retire_aborted()
        policy = self.config.restart_policy
        if self.config.processing_guarantee == GUARANTEE_NONE:
            # nothing committed to restore from — a restart would replay
            # the stream into sinks that already saw it
            self.status = JOB_FAILED
            return
        if self.auto_restarts >= policy.max_restarts:
            self.status = JOB_FAILED
            return
        self.auto_restarts += 1
        self.status = JOB_RESTARTING
        self._restart_due_at = (self.cluster.clock.now()
                                + policy.delay_for(self.auto_restarts))

    def _note_failures(self, failures) -> None:
        """Failure fingerprinting + crash-loop escalation ladder.

        Rung 1 — any attributed failure marks its vertex *suspect*: the
        next execution runs it in pinpoint mode (one record per
        ``process`` call), so a deterministic raise identifies the exact
        in-flight record.  Rung 2 — a fingerprint (vertex, exception
        type, restored snapshot id) recurring ``fingerprint_threshold``
        times is a deterministic crash: fall back one entry down the
        snapshot chain, and when the recurrence carries a pinpointed
        poison record, quarantine it to the dead-letter queue so the
        next attempt drops it instead of dying on it."""
        from ..runtime.supervisor import failure_fingerprint
        policy = self.config.restart_policy
        for f in failures:
            vertex = getattr(f, "vertex", None)
            if vertex:
                self.suspect_vertices.add(vertex)
            fp = failure_fingerprint(f, self._restored_sid)
            count = self._fp_counts[fp] = self._fp_counts.get(fp, 0) + 1
            if count < policy.fingerprint_threshold:
                continue
            self._fp_counts[fp] = 0
            chain = self.cluster.snapshot_store.recovery_chain(self.id)
            if len(chain) > 1:
                self._fallback_depth = min(self._fallback_depth + 1,
                                           len(chain) - 1)
            quarantined = None
            poison = getattr(f, "poison", None)
            if poison is not None and poison.get("exact"):
                if self.dead_letters.quarantine(
                        poison["vertex"], poison["identity"],
                        poison["record"],
                        reason=(f"fingerprint {fp!r} recurred "
                                f"{count}x")):
                    quarantined = poison["record"]
                # the culprit is known; no need to keep replaying the
                # vertex one record at a time
                self.suspect_vertices.discard(poison["vertex"])
            self.recovery_log.append({
                "event": "escalation", "fingerprint": repr(fp),
                "recurrences": count,
                "fallback_depth": self._fallback_depth,
                "quarantined": quarantined})

    def _select_restore_snapshot(self):
        """Walk the store's recovery chain (newest first) to the newest
        usable snapshot: entries within the current escalation fallback
        depth are skipped outright, then each candidate must pass the
        store's integrity verification and load.  Returns
        ``(snapshot_id | None, skipped)`` where ``skipped`` records every
        rejected id with its reason."""
        store = self.cluster.snapshot_store
        skipped: List[Dict[str, Any]] = []
        for depth, sid in enumerate(store.recovery_chain(self.id)):
            if depth < self._fallback_depth:
                skipped.append({"snapshot_id": sid,
                                "reason": "escalation fallback "
                                          "(deterministic crash replayed "
                                          "from this epoch)"})
                continue
            ok, reason = store.verify(self.id, sid)
            if not ok:
                skipped.append({"snapshot_id": sid,
                                "reason": f"verification failed: {reason}"})
                continue
            ok, reason = store.prepare_restore(self.id, sid)
            if not ok:
                skipped.append({"snapshot_id": sid,
                                "reason": f"restore load failed: {reason}"})
                continue
            return sid, skipped
        return None, skipped

    def recovery_diagnostics(self) -> Dict[str, Any]:
        """Everything the recovery path decided, for job stats, the
        chaos bench report and the CI artifact: restores with their
        skipped snapshot ids + reasons, escalations with fingerprints
        and fallback depths, and the dead-letter accounting."""
        return {
            "auto_restarts": self.auto_restarts,
            "snapshots_aborted": self.snapshots_aborted,
            "fallback_depth": self._fallback_depth,
            "suspect_vertices": sorted(self.suspect_vertices),
            "recovery_log": list(self.recovery_log),
            "dead_letters": self.dead_letters.summary(),
            "failures": [repr(f) for f in self.failures],
        }

    def maybe_heal(self, now: float) -> None:
        """Run the pending self-heal restart once its backoff elapsed."""
        if (self.status == JOB_RESTARTING
                and self._restart_due_at is not None
                and now >= self._restart_due_at):
            self._restart_due_at = None
            self.restart()

    def _on_snapshot_complete(self, snapshot_id: int) -> None:
        store = self.cluster.snapshot_store
        # job-level replay meta rides the durable manifest so a cold
        # start (recover_job) can adopt the job's config from disk alone
        store.set_meta(self.id, snapshot_id, "job", {
            "name": self.config.name,
            "guarantee": self.config.processing_guarantee,
            "snapshot_interval_s": self.config.snapshot_interval_s,
        })
        store.commit(self.id, snapshot_id)
        self.snapshots_taken += 1
        # a freshly committed snapshot is a trusted chain head again: it
        # includes the progress made after any escalated fallback
        self._fallback_depth = 0
        # phase-2 release for transactional sinks (paper §4.5), delivered
        # wherever the processors actually live (this thread or a worker
        # process)
        self.cluster.backend.notify_snapshot_committed(self.execution,
                                                       snapshot_id)

    # -- lifecycle -------------------------------------------------------------------
    def start(self) -> None:
        self.execution = ExecutionContext(self, self.cluster)
        self.cluster.backend.start_execution(self.execution)

    def restart(self) -> None:
        """Rebuild the execution on the current topology and restore the
        newest *usable* snapshot (paper §4.4 recovery protocol, hardened:
        the chain is walked with verification + escalation fallback, see
        :meth:`_select_restore_snapshot`)."""
        self.restarts += 1
        self.status = JOB_RESTARTING
        # drop the old execution (its tasklets/queues/processes die with it)
        old = self.execution
        if old is not None:
            self.cluster.backend.stop_execution(old)
            if old.ssctx is not None:
                self._aborted_before += old.ssctx.aborted_count
                old.ssctx.retire_aborted()
        self.execution = ExecutionContext(self, self.cluster)
        sid, skipped = self._select_restore_snapshot()
        restored_entries = 0
        if sid is not None:
            restored_entries = self.execution.restore_from_snapshot(sid)
        self._restored_sid = sid
        if skipped or sid is not None:
            self.recovery_log.append({
                "event": "restore", "restart": self.restarts,
                "restored_snapshot": sid, "entries": restored_entries,
                "skipped": skipped,
                "fallback_depth": self._fallback_depth})
        self._last_snapshot_at = self.cluster.clock.now()
        # start AFTER the restore: a forking backend must hand workers the
        # restored state
        self.cluster.backend.start_execution(self.execution)
        self.status = JOB_RUNNING


class JetNode:
    def __init__(self, node_id: int, cooperative_threads: int):
        self.node_id = node_id
        self.workers = [CooperativeWorker(f"n{node_id}-w{i}")
                        for i in range(cooperative_threads)]


class JetCluster:
    """A Jet cluster; execution substrate selected by ``backend``
    (``"inproc"`` — cooperative simulation on this thread, ``"mp"`` — one
    OS process per (node, cooperative thread), or a custom
    :class:`~repro_torch.core.backend.ExecutionBackend` instance)."""

    def __init__(self, n_nodes: int = 1, cooperative_threads: int = 2,
                 clock: Optional[Clock] = None,
                 partition_count: int = PARTITION_COUNT,
                 backup_count: int = 1,
                 link_latency_s: float = 0.0005,
                 idle_backoff: bool = True,
                 backend="inproc",
                 snapshot_dir=None,
                 snapshot_retain: int = 3):
        self.clock = clock or WallClock()
        self.backend: ExecutionBackend = make_backend(backend)
        if not self.backend.clock_supported(self.clock):
            raise ValueError(
                f"backend {self.backend.name!r} does not support "
                f"{type(self.clock).__name__} (worker processes cannot "
                "observe a driver-stepped virtual clock)")
        self.cooperative_threads = cooperative_threads
        self.link_latency_s = link_latency_s
        #: progressive spin->yield->park when a wall-clock driver is idle
        self.idle_backoff = idle_backoff
        self._idle_streak = 0
        self.node_ids = list(range(n_nodes))
        self.nodes: Dict[int, JetNode] = {
            i: JetNode(i, cooperative_threads) for i in self.node_ids}
        self.imap_service = IMapService(self.node_ids,
                                        partition_count=partition_count,
                                        backup_count=backup_count)
        # ``snapshot_dir`` upgrades snapshot storage to the durable tier:
        # committed snapshots spill to disk as a verified retention chain
        # of the last ``snapshot_retain`` epochs (state/durable_store.py),
        # surviving coordinator death (see recover_job) and detecting
        # corrupt snapshots at restore time
        if snapshot_dir is not None:
            self.snapshot_store: SnapshotStore = DurableSnapshotStore(
                self.imap_service, snapshot_dir, retain=snapshot_retain)
        else:
            self.snapshot_store = SnapshotStore(self.imap_service)
        self.jobs: List[Job] = []
        self._next_node_id = n_nodes
        self.backend.bind(self)

    # -- job control ---------------------------------------------------------------
    def submit(self, dag: DAG, config: Optional[JobConfig] = None) -> Job:
        job = Job(self, dag, config or JobConfig())
        job.start()
        self.jobs.append(job)
        return job

    def recover_job(self, dag: DAG, job_id: Optional[str] = None,
                    config: Optional[JobConfig] = None) -> Job:
        """Cold-start adoption: rebuild a job from the durable snapshot
        chain alone — nothing from the coordinator that wrote it
        survives.  ``dag`` must be the job's pipeline rebuilt by the
        caller (processor code is not serialized, matching Jet's
        resubmit-the-job model); ``job_id`` may be omitted when the
        store holds exactly one job.  The job's processing guarantee and
        snapshot cadence are adopted from the newest readable manifest
        when ``config`` is not given, snapshot ids continue after the
        chain head, and the usual verified chain walk picks the restore
        point — so a corrupt head falls back exactly as it would in a
        live restart."""
        store = self.snapshot_store
        jobs = [j for j in store.discover_jobs() if store.recovery_chain(j)]
        if job_id is None:
            if len(jobs) != 1:
                raise ValueError(
                    f"recover_job needs an explicit job_id: store holds "
                    f"{jobs!r}")
            job_id = jobs[0]
        chain = store.recovery_chain(job_id)
        if not chain:
            raise ValueError(f"no durable snapshots for job {job_id!r}")
        if config is None:
            meta: Dict[str, Any] = {}
            for sid in chain:       # newest readable manifest wins
                manifest = getattr(store, "manifest", lambda *a: None)(
                    job_id, sid)
                if manifest and manifest.get("meta", {}).get("job"):
                    meta = manifest["meta"]["job"]
                    break
            config = JobConfig(
                name=meta.get("name", job_id),
                processing_guarantee=meta.get("guarantee",
                                              GUARANTEE_EXACTLY_ONCE),
                snapshot_interval_s=meta.get("snapshot_interval_s", 1.0))
        job = Job(self, dag, config, job_id=job_id)
        job._next_snapshot_id = chain[0] + 1
        job.execution = ExecutionContext(job, self)
        sid, skipped = job._select_restore_snapshot()
        restored_entries = 0
        if sid is not None:
            restored_entries = job.execution.restore_from_snapshot(sid)
        job._restored_sid = sid
        job.recovery_log.append({
            "event": "cold_start", "restored_snapshot": sid,
            "entries": restored_entries, "skipped": skipped,
            "chain": chain})
        self.backend.start_execution(job.execution)
        self.jobs.append(job)
        return job

    # -- driver ---------------------------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration across the whole cluster."""
        progress = self.backend.step(self.jobs)
        for job in self.jobs:
            # detected (uncooperative) failures first: a job whose workers
            # died must not be ticked for snapshots or marked completed
            failures = self.backend.take_failures(job.execution)
            if failures:
                job.on_detected_failure(failures)
                progress = True
            job.maybe_heal(self.clock.now())
            job.tick(self.clock.now())
            if (job.status == JOB_RUNNING
                    and self.backend.execution_done(job.execution)):
                job.status = JOB_COMPLETED
                # release substrate resources (worker processes, shm rings)
                # the moment the data plane finished
                self.backend.stop_execution(job.execution)
        if progress:
            self._idle_streak = 0
        elif isinstance(self.clock, VirtualClock):
            self.clock.advance(self.clock.auto_step)
        elif self.idle_backoff:
            self._idle_streak = streak = self._idle_streak + 1
            if streak > IDLE_YIELD_ITERS:
                park = IDLE_PARK_MIN_S * (1 << min(streak - IDLE_YIELD_ITERS,
                                                   8))
                _time.sleep(min(park, IDLE_PARK_MAX_S))
            elif streak > IDLE_SPIN_ITERS:
                _time.sleep(0)      # yield the timeslice
        return progress

    def run_until_complete(self, job: Job, max_steps: int = 2_000_000) -> None:
        for _ in range(max_steps):
            if job.status == JOB_COMPLETED:
                return
            if job.status == JOB_FAILED:
                raise JobFailedError(job)
            self.step()
        raise TimeoutError(
            f"job {job.id} did not complete in {max_steps} steps "
            f"(stats: {job.execution.stats()})")

    def run_steps(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def shutdown(self) -> None:
        """Tear down substrate resources of every execution (terminate
        worker processes, unlink shared memory).  Idempotent; a no-op for
        the in-process backend beyond unhooking tasklets."""
        for job in self.jobs:
            if job.execution is not None:
                self.backend.stop_execution(job.execution)
        self.backend.shutdown()

    # -- telemetry -------------------------------------------------------------
    def vertex_time_share(self) -> Dict[str, float]:
        """Fraction of sampled worker time spent in each vertex.

        Aggregates the cooperative workers' sampled per-tasklet timing
        (see :class:`CooperativeWorker`) across all nodes, summed per
        vertex (tasklet names are ``vertex#globalIndex``), normalized to
        shares.  This is where the next perf PR should look first.
        """
        time_in: Dict[str, float] = {}
        for node in self.nodes.values():
            for worker in node.workers:
                for name, secs in worker._time_in.items():
                    vertex = name.rsplit("#", 1)[0]
                    time_in[vertex] = time_in.get(vertex, 0.0) + secs
        total = sum(time_in.values())
        if total <= 0:
            return {}
        return {v: round(s / total, 4)
                for v, s in sorted(time_in.items(), key=lambda kv: -kv[1])}

    # -- membership -----------------------------------------------------------------
    def kill_node(self, node_id: int) -> None:
        """Fail a member: IMap promotes backups; running jobs restart from
        their latest committed snapshot on the surviving members."""
        if len(self.node_ids) == 1:
            raise ValueError("cannot kill the last node")
        self.node_ids.remove(node_id)
        del self.nodes[node_id]
        self.imap_service.kill_member(node_id)
        for job in self.jobs:
            if job.status in (JOB_RUNNING, JOB_RESTARTING):
                job.restart()

    def add_node(self) -> int:
        """Elastic scale-out: join a member, rebalance partitions, restart
        jobs so the new member takes its share of the work (§4.3)."""
        node_id = self._next_node_id
        self._next_node_id += 1
        self.node_ids.append(node_id)
        self.nodes[node_id] = JetNode(node_id, self.cooperative_threads)
        self.imap_service.add_member(node_id)
        for job in self.jobs:
            if job.status in (JOB_RUNNING, JOB_RESTARTING):
                job.restart()
        return node_id
