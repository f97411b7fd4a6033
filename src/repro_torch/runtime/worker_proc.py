"""True multi-process execution: one OS process per cooperative worker.

:class:`MultiprocessBackend` implements the
:class:`~repro_torch.core.backend.ExecutionBackend` contract by turning every
(node, cooperative-thread) pair of the planned execution into a real
``fork``-spawned worker process.  Edges between tasklets in the same
process stay plain :class:`~repro_torch.core.queues.SPSCQueue`s; every edge that
crosses a process boundary — local threads of one JetNode as much as
cross-node links — becomes a fixed-capacity shared-memory
:class:`~repro_torch.core.shm_ring.ShmRing` carrying EventBlock columns as raw
slabs plus a control lane for watermarks/barriers/scalar stragglers.

Coordination stays in the parent ("coordinator"), which never touches the
data plane:

* a duplex pipe per worker carries control: parent -> child ``("snapshot",
  id)`` / ``("committed", id)`` / ``("stop",)``; child -> parent
  ``("ack", id, entries)`` / ``("results", batch)`` / ``("done", stats)``
  / ``("error", traceback)``.
* the Chandy-Lamport protocol itself is unchanged — barriers flow through
  the rings exactly as through in-process queues; each worker aligns and
  snapshots its local tasklets, buffers the state entries, and ships them
  with its ack.  :class:`MpSnapshotContext` (parent side) completes the
  snapshot when every live worker acked, lands all entries in the
  IMap-backed store in one bulk write, commits, and broadcasts phase 2.
* ``kill_node`` / ``add_node`` keep their whole-job restart semantics:
  the backend tears every worker process down, the engine rebuilds and
  restores in the parent, and ``start_execution`` re-forks — children
  inherit the restored state, so exactly-once replay works unchanged.
* sink results (processors exposing an ``out`` list, e.g.
  :class:`~repro_torch.core.sources.CollectorSink`) are shipped incrementally to
  the parent and merged into the parent-side processor's list, so tests
  and benchmarks observe results exactly as under the in-process backend.

Workers inherit the built execution via ``fork`` (no pickling of the DAG
or closures); only items crossing rings and control messages serialize.

The port's copy of ``repro/runtime/worker_proc.py``, the same protocol
and names.  The fork decides what a worker may hold: a CUDA context does
not survive ``fork`` (PyTorch raises in a forked child that touches CUDA
after its parent did), so, as the reference does for its accelerator, a
job with a device-offloaded vertex (any tasklet with ``_poll_async``)
is refused before any worker starts, and every worker runs host
processors only.  Importing ``repro_torch.core`` creates no CUDA
context.  Keep the processors of a job on this backend numpy only: a
forked child that runs a threaded torch CPU operation after its parent
used torch's intra-op pool can deadlock.

The conventions above are jetlint-enforced (ROADMAP "Machine-checked
contracts"): the control-pipe vocabulary is closed by the
``protocol-unhandled-message`` / ``protocol-dead-arm`` pass — every tag
sent on either side of the fork must have a dispatch arm on the other,
and every arm a live sender (``repro.analysis.protocol`` classifies
call sites coordinator vs worker by reachability from
:func:`_worker_main`); the "coordinator never touches the data plane"
rule is the process-role half of ``ring-role-violation``
(``repro.analysis.ring_roles``); and pipe/process/shm acquisitions here
carry ``resource-leak`` obligations — the pass caught the parent's copy
of ``child_conn`` leaking on failed spawns in exactly this module.

Failure semantics: cooperative vs detected
==========================================

``kill_node`` / ``add_node`` above are *cooperative* failures — the
engine initiates them, tears the attempt down in order, and restarts
unconditionally.  Everything below is about failures the engine did NOT
schedule:

* children heartbeat (``("hb",)`` every :data:`_HEARTBEAT_S` seconds) on
  their control pipe; the coordinator-side
  :class:`~repro_torch.runtime.supervisor.WorkerSupervisor` classifies a worker
  as **crashed** (exitcode < 0 without DONE — e.g. SIGKILL'd by the OS),
  **hung** (live process, heartbeat older than the deadline — wedged,
  SIGSTOP'd, deadlocked; the supervisor SIGKILLs it), or **error-exited**
  (the child shipped ``("error", traceback)`` and re-raised).
* ``step``/``_drain_handle`` route ``EOFError``/``BrokenPipeError`` from
  a dead worker's pipe into this detection instead of crashing the
  coordinator or silently dropping the worker: the handle is marked dead,
  the snapshot context is told (see below), and the supervisor's next
  check turns the exitcode into a :class:`~repro_torch.core.backend
  .WorkerFailure` surfaced via ``take_failures`` — the engine's
  :class:`~repro_torch.core.engine.RestartPolicy` then drives the same
  teardown -> restore-from-committed-snapshot -> re-fork path as
  ``kill_node``, with bounded attempts and exponential backoff.

Abort vs commit rules for the barrier protocol:

* a snapshot COMMITS only when every worker received its barrier
  broadcast and acked with its buffered state entries.  The reference
  exempts workers that finished their data plane ("they hold no
  in-flight state"); the port aborts instead (ROADMAP.md §3, F4): a
  finished worker's final state (its sources' end offsets, its windows'
  emitted fronts) is then missing from the snapshot, and a restore from
  it replays those sources into windows restored without them — partial
  counts.  Once a worker finished, the last snapshot taken before stays
  authoritative;
* a snapshot is ABORTED — buffered entries discarded, ``aborted_count``
  bumped, the previous *committed* snapshot left authoritative, the job
  free to schedule a new snapshot — whenever its barrier protocol can no
  longer complete: the ack deadline (``JobConfig.barrier_timeout_s``)
  lapses, a worker dies or finishes holding an un-acked barrier, a
  worker had finished before the barrier (no broadcast is sent then), or
  the barrier broadcast itself hits a dead pipe.  An abort never stalls the job and
  never completes with partial state.
* children **serialize barrier generations**: an abort lets the
  coordinator begin snapshot *n+1* while a loaded worker still has the
  ``("snapshot", n)`` command queued, so a child begins each queued id
  only after its previous local snapshot completed — every barrier id is
  emitted into the rings, in order, and downstream alignment can never
  park on a generation that nobody will ever forward (the coordinator
  simply ignores late acks for aborted ids).
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import time as _time
import traceback
from multiprocessing import connection as _mpc
from typing import Any, Dict, List, Optional, Tuple

from ..core.backend import (ExecutionBackend, FAILURE_ERROR, Location,
                            WorkerFailure)
from ..core.clock import Clock, VirtualClock
from ..core.queues import SPSCQueue
from ..core.shm_ring import DEFAULT_RING_BYTES, ShmRing
from ..core.tasklet import (CooperativeWorker, GUARANTEE_NONE,
                            SnapshotContext)
from ..state.snapshot_store import own_snapshot_value
from .supervisor import DEFAULT_HEARTBEAT_TIMEOUT_S, WorkerSupervisor

_MP = multiprocessing.get_context("fork")

#: child idle backoff (spin -> yield -> park), mirroring the engine driver
_IDLE_SPIN_ITERS = 64
_IDLE_YIELD_ITERS = 192
_IDLE_PARK_MIN_S = 0.00005
_IDLE_PARK_MAX_S = 0.0005
#: how often a child ships new sink results to the coordinator
_RESULT_SHIP_S = 0.02
#: command-pipe poll cadence (iterations) while the child is busy
_CMD_POLL_ITERS = 32
#: child liveness heartbeat cadence (supervisor deadline is several x this)
_HEARTBEAT_S = 0.25


class _BufferWriter:
    """Child-local SnapshotWriter stand-in: buffers entries until the ack
    ships them to the coordinator.  Values are copied at ``put`` time —
    the processor keeps mutating its live containers between its barrier
    and the worker-wide ack, and a buffered reference would ship the
    mutated state (see :func:`repro_torch.state.snapshot_store
    .own_snapshot_value`)."""

    __slots__ = ("entries",)

    def __init__(self):
        self.entries: List[Tuple] = []

    def put(self, snapshot_id: int, vertex: str, key, value, pid: int,
            instance: int = 0) -> None:
        self.entries.append((snapshot_id, vertex, key,
                             own_snapshot_value(value), pid, instance))

    def take(self, snapshot_id: int) -> List[Tuple]:
        """The entries of ``snapshot_id``.  Entries of a later id stay
        buffered (tasklets that aligned on its barrier before this worker
        began it, F11); those of an earlier, aborted id go."""
        out, keep = [], []
        for entry in self.entries:
            if entry[0] == snapshot_id:
                out.append(entry)
            elif entry[0] > snapshot_id:
                keep.append(entry)
        self.entries = keep
        return out


def _sink_list(processor) -> Optional[list]:
    """The results list of a collector-style sink, if this processor is
    one (duck-typed: an ``out`` attribute holding a list)."""
    out = getattr(processor, "out", None)
    return out if isinstance(out, list) else None


def _tasklet_stats(tasklet) -> Dict[str, Any]:
    p = tasklet.processor
    inner = getattr(p, "inner", p)
    stats: Dict[str, Any] = {
        "items_in": tasklet.items_in, "items_out": tasklet.items_out,
        "calls": tasklet.calls, "idle_calls": tasklet.idle_calls,
    }
    for obj in (p, inner):
        if hasattr(obj, "late_dropped"):
            stats["late_dropped"] = obj.late_dropped
            break
    start = getattr(inner, "_start", None)
    if isinstance(start, float):
        stats["source_start"] = start
    return stats


def _apply_stats(tasklet, stats: Dict[str, Any]) -> None:
    tasklet.items_in = stats["items_in"]
    tasklet.items_out = stats["items_out"]
    tasklet.calls = stats["calls"]
    tasklet.idle_calls = stats["idle_calls"]
    if "late_dropped" in stats:
        p = tasklet.processor
        target = p if hasattr(p, "late_dropped") else getattr(p, "inner", p)
        target.late_dropped = stats["late_dropped"]


# --------------------------------------------------------------------------
# child side
# --------------------------------------------------------------------------

def _ship_results(conn, sinks) -> None:
    batch = []
    for entry in sinks:
        name, out, cursor = entry
        n = len(out)
        if n > cursor:
            batch.append((name, out[cursor:n]))
            entry[2] = n
    if batch:
        conn.send(("results", batch))


def _worker_main(execution, key: Location, conn) -> None:
    """Entry point of one worker process (runs post-fork; everything it
    needs — tasklets, queues, rings — arrived by inheritance)."""
    try:
        assignment = execution.backend_data["assignment"]
        tasklets = [t for t in execution.tasklets
                    if assignment[id(t)] == key]
        parent_ctx = execution.ssctx
        writer = _BufferWriter()
        local_ctx = SnapshotContext(parent_ctx.guarantee, writer)
        local_ctx.requested_id = parent_ctx.requested_id
        local_ctx.completed_id = parent_ctx.completed_id
        local_ctx.tasklets = tasklets

        def _acked(snapshot_id: int) -> None:
            # F7: the results this worker's sinks took before the barrier
            # go out ahead of the ack.  Once the snapshot commits, a
            # restore never replays them: left for the next periodic
            # ship, they die with the worker if it is killed first
            _ship_results(conn, sinks)
            conn.send(("ack", snapshot_id, writer.take(snapshot_id)))

        local_ctx.on_complete = _acked
        worker = CooperativeWorker(f"n{key[0]}-w{key[1]}")
        for t in tasklets:
            t.ssctx = local_ctx
            worker.add(t)
        sinks = [[t.name, out, len(out)] for t in tasklets
                 for out in (_sink_list(t.processor),) if out is not None]

        idle_streak = 0
        done_sent = False
        pending_snapshots: List[int] = []
        last_ship = last_hb = _time.monotonic()
        iters = 0
        while True:
            iters += 1
            if done_sent or not iters % _CMD_POLL_ITERS or idle_streak:
                while conn.poll(0):
                    cmd = conn.recv()
                    op = cmd[0]
                    if op == "snapshot":
                        # Serialize barrier generations.  Two snapshot
                        # commands can be queued back-to-back when the
                        # coordinator ABORTS snapshot n (ack deadline) and
                        # begins n+1 before this (descheduled, loaded)
                        # worker drained its pipe.  Calling begin(n+1)
                        # straight over begin(n) would mean no tasklet
                        # slice ever observes requested_id == n, so this
                        # worker's sources would never emit barrier n into
                        # the rings — while a faster sibling worker DID
                        # forward n, leaving downstream tasklets parked on
                        # a mix of generations that can never align (a
                        # permanent, heartbeat-alive wedge).  Begin each
                        # id only after the previous local snapshot
                        # completed, so every barrier id is emitted, in
                        # order; the coordinator ignores late acks for
                        # aborted ids.
                        pending_snapshots.append(cmd[1])
                    elif op == "committed":
                        for t in tasklets:
                            hook = getattr(t.processor,
                                           "on_snapshot_committed", None)
                            if hook is not None:
                                hook(cmd[1])
                    elif op == "chaos_raise":
                        # parent-triggered fault: plant an exception in the
                        # named (or first live) tasklet's next slice
                        live = [t for t in tasklets if not t.is_done]
                        target = next((t for t in live if t.name == cmd[1]),
                                      live[0] if live else None)
                        if target is not None:
                            target._chaos_exc = RuntimeError(cmd[2])
                    elif op == "stop":
                        _ship_results(conn, sinks)
                        return
            if (pending_snapshots
                    and local_ctx.completed_id == local_ctx.requested_id):
                local_ctx.begin(pending_snapshots.pop(0))
            progress = worker.run_iteration()
            now = _time.monotonic()
            if now - last_hb >= _HEARTBEAT_S:
                conn.send(("hb",))
                last_hb = now
            if sinks and now - last_ship >= _RESULT_SHIP_S:
                _ship_results(conn, sinks)
                last_ship = now
            if not done_sent and all(t.is_done for t in tasklets):
                _ship_results(conn, sinks)
                conn.send(("done",
                           [(t.name, _tasklet_stats(t)) for t in tasklets]))
                done_sent = True
            if progress:
                idle_streak = 0
            elif done_sent:
                # data plane finished: block on the command pipe
                conn.poll(0.05)
            else:
                idle_streak += 1
                if idle_streak > _IDLE_YIELD_ITERS:
                    park = _IDLE_PARK_MIN_S * (
                        1 << min(idle_streak - _IDLE_YIELD_ITERS, 8))
                    _time.sleep(min(park, _IDLE_PARK_MAX_S))
                elif idle_streak > _IDLE_SPIN_ITERS:
                    _time.sleep(0)
    except (EOFError, BrokenPipeError, KeyboardInterrupt):
        pass
    except BaseException as e:
        # ship the full traceback to the coordinator (it becomes the
        # WorkerFailure detail) and exit nonzero WITHOUT re-raising:
        # multiprocessing's bootstrap would print a duplicate traceback
        # for a failure the parent is about to handle and heal.  The
        # attribution info (vertex, root exception type, any pinpointed
        # poison record) rides along so the engine's failure
        # fingerprinting works across the process boundary.
        cause = getattr(e, "cause", e)
        info = {
            "vertex": getattr(getattr(e, "tasklet", None),
                              "vertex_name", None),
            "exc_type": type(cause).__name__,
            "poison": getattr(cause, "_jet_poison", None),
        }
        try:
            conn.send(("error", traceback.format_exc(), info))
        except Exception:
            try:
                # a poison payload that does not pickle must not mask
                # the failure report itself
                info["poison"] = None
                conn.send(("error", traceback.format_exc(), info))
            except Exception:
                pass
        try:
            conn.close()
        except Exception:
            pass
        os._exit(1)
    finally:
        try:
            conn.close()
        except Exception:
            pass


# --------------------------------------------------------------------------
# parent side
# --------------------------------------------------------------------------

class MpSnapshotContext(SnapshotContext):
    """Coordinator-side snapshot state: ``begin`` broadcasts to workers,
    completion needs an ack (with state entries) from every live worker;
    entries land in the snapshot store in one bulk write before commit.

    Unlike the in-process context, acks here CAN be lost (a worker dies
    holding an un-acked barrier, or the barrier broadcast itself hits a
    dead pipe), so an in-flight snapshot may be **aborted**: buffered
    entries are discarded, ``aborted_count`` is bumped and the last
    *committed* snapshot stays authoritative — ``on_complete`` (which
    commits) is never called for an aborted snapshot, and late acks for
    it are ignored.  ``ack_timeout_s`` (wired from
    ``JobConfig.barrier_timeout_s``) bounds how long a snapshot may wait
    for its acks before the engine's ``check_timeout`` poll aborts it."""

    __slots__ = ("backend", "execution", "store_writer", "ack_timeout_s",
                 "_await", "_entries", "_deadline")

    def __init__(self, guarantee: str, store_writer):
        super().__init__(guarantee, writer=None)
        self.backend: Optional["MultiprocessBackend"] = None
        self.execution = None
        self.store_writer = store_writer
        self.ack_timeout_s: Optional[float] = None
        self._await: set = set()
        self._entries: List[Tuple] = []
        self._deadline: Optional[float] = None

    def begin(self, snapshot_id: int) -> None:
        self.requested_id = snapshot_id
        self._entries = []
        if self.ack_timeout_s is not None:
            self._deadline = _time.monotonic() + self.ack_timeout_s
        finished = self.backend.finished_workers(self.execution)
        if finished:
            # a finished worker cannot contribute its final state: the
            # snapshot would not be a consistent cut (module docstring)
            self.abort(f"workers {sorted(finished)} finished before the "
                       f"barrier")
            return
        reached, failed = self.backend.broadcast(self.execution,
                                                 ("snapshot", snapshot_id))
        self._await = reached
        if failed:
            # a not-yet-done worker never received its barrier: it will
            # never align, so this snapshot cannot be consistent
            self.abort(f"barrier broadcast failed for workers {failed}")
            return
        self._maybe_complete()

    def worker_ack(self, key: Location, snapshot_id: int,
                   entries: List[Tuple]) -> None:
        if (snapshot_id != self.requested_id
                or self.completed_id == self.requested_id):
            return      # stale, or a late ack for an aborted snapshot
        self._entries.extend(entries)
        self._await.discard(key)
        self._maybe_complete()

    def worker_gone(self, key: Location, crashed: bool = False) -> None:
        """A worker left the data plane: ``crashed=False`` means it
        finished cleanly (reported DONE), ``crashed=True`` that it died.
        Either way, if it still owed us an ack its state is not in the
        snapshot, which must be aborted, never completed without it (the
        reference exempts a finished worker; module docstring)."""
        if key not in self._await:
            return
        how = "died" if crashed else "finished"
        self.abort(f"worker {key} {how} holding an un-acked barrier")

    def abort(self, reason: str = "") -> None:
        """Abort the in-flight snapshot: discard buffered entries, retire
        the ongoing snapshot's IMap storage, leave the last committed
        snapshot authoritative, and free the job to schedule a new
        snapshot.  No commit, no ``on_complete``."""
        if self.completed_id == self.requested_id:
            return      # nothing in flight
        self._entries = []
        self._await = set()
        self._deadline = None
        # destroy the aborted epoch's IMap storage BEFORE marking it
        # complete: entries may have landed there (e.g. a partial
        # put_many, or a restore that reused the id) and nothing will
        # ever commit or retire this id again — without the destroy the
        # __jet.snapshot.<job>.<id> map leaks for the life of the cluster
        self.retire_aborted()
        self.completed_id = self.requested_id
        self.aborted_count += 1

    def retire_aborted(self) -> None:
        # the mp context writes through store_writer, not the base
        # class's writer slot
        if (self.store_writer is not None
                and self.completed_id != self.requested_id):
            store = self.store_writer.store
            store._map(self.store_writer.job_id, self.requested_id).destroy()

    def check_timeout(self) -> bool:
        if (self.completed_id != self.requested_id
                and self._deadline is not None
                and _time.monotonic() > self._deadline):
            self.abort(f"barrier acks overdue after {self.ack_timeout_s}s")
            return True
        return False

    def _maybe_complete(self) -> None:
        if self.completed_id == self.requested_id or self._await:
            return
        if self.store_writer is not None and self._entries:
            self.store_writer.put_many(self._entries)
        self._entries = []
        self._deadline = None
        self.completed_id = self.requested_id
        if self.on_complete is not None:
            self.on_complete(self.completed_id)


class _WorkerHandle:
    __slots__ = ("key", "proc", "conn", "alive", "done")

    def __init__(self, key: Location, proc, conn):
        self.key = key
        self.proc = proc
        self.conn = conn
        self.alive = True
        self.done = False


def _kill_handle_hard(proc) -> None:
    """Last-resort teardown for a worker that survived ``terminate()``:
    SIGTERM stays *pending* on a SIGSTOPped process, so escalate to
    SIGKILL (which cannot be blocked or stopped) and reap."""
    try:
        os.kill(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, OSError):  # pragma: no cover
        pass
    proc.join(timeout=5.0)


class MultiprocessBackend(ExecutionBackend):
    """Execution substrate running cooperative workers as OS processes
    over shared-memory rings (module docstring has the full protocol)."""

    name = "mp"

    def __init__(self, ring_bytes: int = DEFAULT_RING_BYTES,
                 heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S):
        super().__init__()
        self.ring_bytes = ring_bytes
        self.heartbeat_timeout_s = heartbeat_timeout_s

    def clock_supported(self, clock: Clock) -> bool:
        return not isinstance(clock, VirtualClock)

    # -- build time ----------------------------------------------------------
    def create_snapshot_context(self, job):
        writer = (self.cluster.snapshot_store.writer(job.id)
                  if job.config.processing_guarantee != GUARANTEE_NONE
                  else None)
        ctx = MpSnapshotContext(job.config.processing_guarantee, writer)
        ctx.ack_timeout_s = job.config.barrier_timeout_s
        return ctx

    def make_transport(self, execution, edge, src: Location, dst: Location):
        if src == dst:
            return SPSCQueue(edge.queue_size)
        ring = ShmRing(self.ring_bytes)
        execution.backend_data.setdefault("rings", []).append(ring)
        return ring

    def assign_tasklet(self, execution, inst, tasklet) -> None:
        key = (inst.node,
               inst.local_index % self.cluster.cooperative_threads)
        data = execution.backend_data
        data.setdefault("assignment", {})[id(tasklet)] = key
        data.setdefault("by_worker", {}).setdefault(key, []).append(tasklet)

    # -- lifecycle -----------------------------------------------------------
    def start_execution(self, execution) -> None:
        data = execution.backend_data
        if data.get("started"):
            return
        for t in execution.tasklets:
            if t._poll_async is not None:
                # nothing started: release the rings built for the plan
                # now rather than at garbage collection
                for ring in data.pop("rings", ()):
                    ring.unlink()
                    ring.close()
                raise NotImplementedError(
                    "device-offloaded vertices need the coordinator's "
                    "accelerator context; run them on backend='inproc'")
        ssctx = execution.ssctx
        ssctx.backend = self
        ssctx.execution = execution
        supervisor = WorkerSupervisor(self.heartbeat_timeout_s)
        workers: Dict[Location, _WorkerHandle] = {}
        for key in sorted(data.get("by_worker", {})):
            parent_conn, child_conn = _MP.Pipe(duplex=True)
            try:
                proc = _MP.Process(
                    target=_worker_main, args=(execution, key, child_conn),
                    name=f"jet-n{key[0]}-w{key[1]}", daemon=True)
                proc.start()
            finally:
                # the child inherited its end across the fork; the
                # parent's copy of that fd must close even if the spawn
                # itself blew up, or every failed start leaks a pipe
                child_conn.close()
            workers[key] = _WorkerHandle(key, proc, parent_conn)
            supervisor.worker_started(key)
        data["workers"] = workers
        data["supervisor"] = supervisor
        data["done"] = set()
        data["failures"] = []
        data["by_name"] = {t.name: t for t in execution.tasklets}
        data["started"] = True
        data["stopped"] = False

    def stop_execution(self, execution) -> None:
        data = execution.backend_data
        if not data.get("started") or data.get("stopped"):
            data["stopped"] = True
            return
        # un-stall chaos-SIGSTOPped workers first: a stopped process can
        # neither honor ("stop",) nor die from the pending SIGTERM
        for pid in list(data.get("stalled", {})):
            try:
                os.kill(pid, signal.SIGCONT)
            except (ProcessLookupError, OSError):
                pass
        data.pop("stalled", None)
        workers = data["workers"]
        for h in workers.values():
            if h.alive:
                try:
                    h.conn.send(("stop",))
                except (BrokenPipeError, OSError):
                    h.alive = False
        deadline = _time.monotonic() + 5.0
        pending = list(workers.values())
        while pending and _time.monotonic() < deadline:
            still = []
            for h in pending:
                self._drain_handle(execution, h, detect=False)
                h.proc.join(timeout=0.05)
                if h.proc.exitcode is None:
                    still.append(h)
            pending = still
        for h in pending:  # stuck worker: escalate SIGTERM -> SIGKILL
            h.proc.terminate()
            h.proc.join(timeout=1.0)
            if h.proc.exitcode is None:  # pragma: no cover - hard path
                _kill_handle_hard(h.proc)
        for h in workers.values():
            h.alive = False
            try:
                h.conn.close()
            except Exception:
                pass
        for ring in data.get("rings", ()):
            ring.unlink()
            ring.close()
        data["stopped"] = True

    def shutdown(self) -> None:
        pass    # per-execution teardown covers everything

    # -- driving -------------------------------------------------------------
    def step(self, jobs) -> bool:
        progress = False
        waitable = []
        now = _time.monotonic()
        for job in jobs:
            execution = job.execution
            if execution is None:
                continue
            data = execution.backend_data
            if not data.get("started") or data.get("stopped"):
                continue
            for h in data["workers"].values():
                if h.alive:
                    progress |= self._drain_handle(execution, h,
                                                   detect=True)
                    if h.alive:
                        waitable.append(h.conn)
            progress |= self._deliver_due_acks(execution, now)
            self._resume_due_stalls(data, now)
            supervisor = data["supervisor"]
            failures = supervisor.check(data["workers"].values(), now=now)
            if failures:
                progress = True
                for f in failures:
                    h = data["workers"].get(f.key)
                    if h is not None:
                        h.alive = False
                    # a dead worker can never ack: abort any snapshot
                    # still awaiting it rather than stalling
                    execution.ssctx.worker_gone(f.key, crashed=True)
                data["failures"].extend(failures)
        if not progress and waitable:
            # nothing pending: block briefly on the control pipes instead
            # of burning the coordinator's core (the data plane lives in
            # the workers)
            _mpc.wait(waitable, timeout=0.002)
        return progress

    @staticmethod
    def _deliver_due_acks(execution, now: float) -> bool:
        """Release chaos-delayed barrier acks whose hold expired."""
        delayed = execution.backend_data.get("delayed_acks")
        if not delayed:
            return False
        due = [d for d in delayed if d[0] <= now]
        if not due:
            return False
        execution.backend_data["delayed_acks"] = [
            d for d in delayed if d[0] > now]
        for _, key, snapshot_id, entries in due:
            execution.ssctx.worker_ack(key, snapshot_id, entries)
        return True

    @staticmethod
    def _resume_due_stalls(data, now: float) -> None:
        """SIGCONT chaos-stalled workers whose stall duration elapsed."""
        stalled = data.get("stalled")
        if not stalled:
            return
        for pid, resume_at in list(stalled.items()):
            if resume_at is not None and now >= resume_at:
                try:
                    os.kill(pid, signal.SIGCONT)
                except (ProcessLookupError, OSError):
                    pass
                del stalled[pid]

    def _drain_handle(self, execution, h: _WorkerHandle,
                      detect: bool) -> bool:
        """Pump one worker's control pipe.  In ``detect`` mode (the live
        driving loop) a dead pipe or an ``("error", tb)`` message becomes
        a recorded failure for the restart policy; in teardown mode
        (``detect=False``, from ``stop_execution``) the worker is simply
        marked finished."""
        data = execution.backend_data
        supervisor = data.get("supervisor")
        progress = False
        try:
            while h.conn.poll(0):
                msg = h.conn.recv()
                op = msg[0]
                if op == "hb":
                    if supervisor is not None:
                        supervisor.heartbeat(h.key)
                    continue
                progress = True
                if op == "results":
                    by_name = data["by_name"]
                    for name, items in msg[1]:
                        sink = _sink_list(by_name[name].processor)
                        if sink is not None:
                            sink.extend(items)
                elif op == "ack":
                    if self._chaos_intercept_ack(execution, h.key,
                                                 msg[1], msg[2]):
                        continue
                    execution.ssctx.worker_ack(h.key, msg[1], msg[2])
                elif op == "done":
                    for name, stats in msg[1]:
                        _apply_stats(data["by_name"][name], stats)
                        if "source_start" in stats:
                            starts = data.setdefault("source_starts", {})
                            starts[name] = stats["source_start"]
                    h.done = True
                    data["done"].add(h.key)
                    execution.ssctx.worker_gone(h.key)
                elif op == "error":
                    # the child re-raises after shipping the traceback, so
                    # its exit is imminent; record the failure here (with
                    # the full traceback) instead of crashing the driver
                    h.alive = False
                    info = msg[2] if len(msg) > 2 else {}
                    if detect:
                        if supervisor is not None:
                            supervisor.mark_reported(h.key)
                        data["failures"].append(WorkerFailure(
                            FAILURE_ERROR, key=h.key, pid=h.proc.pid,
                            detail=f"worker {h.key} raised:\n{msg[1]}",
                            vertex=info.get("vertex"),
                            exc_type=info.get("exc_type"),
                            poison=info.get("poison")))
                    execution.ssctx.worker_gone(h.key, crashed=True)
        except (EOFError, OSError):
            # dead pipe: never raise — mark the handle dead and leave
            # classification to the supervisor's exitcode check (detect
            # mode) or mark the worker finished (teardown mode)
            h.alive = False
            if not h.done and not detect:
                h.done = True
                data["done"].add(h.key)
            execution.ssctx.worker_gone(h.key, crashed=not h.done)
        return progress

    def _chaos_intercept_ack(self, execution, key: Location,
                             snapshot_id: int, entries) -> bool:
        """Chaos seam for barrier acks: drop one ack on the floor (the
        snapshot must then abort via its deadline) or hold it for a
        while.  One-shot per injected fault; returns True if the ack was
        intercepted."""
        chaos = execution.backend_data.get("chaos_acks")
        if not chaos or key not in chaos:
            return False
        action, delay_s = chaos.pop(key)
        if action == "drop":
            return True
        execution.backend_data.setdefault("delayed_acks", []).append(
            (_time.monotonic() + delay_s, key, snapshot_id, entries))
        return True

    @staticmethod
    def finished_workers(execution) -> set:
        """Keys of the workers that reported their data plane DONE."""
        return set(execution.backend_data.get("done", ()))

    def execution_done(self, execution) -> bool:
        data = execution.backend_data
        if not data.get("started"):
            return False
        return len(data["done"]) >= len(data["workers"])

    # -- snapshot fan-out ----------------------------------------------------
    def broadcast(self, execution, message) -> Tuple[set, set]:
        """Send ``message`` to every live, not-yet-done worker.  Returns
        ``(reached, failed)``: keys the message reached, and keys of
        workers still owing work (not done) that could NOT be reached —
        dead pipe mid-send, or already marked dead.  A barrier broadcast
        with a non-empty ``failed`` set can never form a consistent
        snapshot (the unreached worker will never align) and must be
        aborted by the caller."""
        reached: set = set()
        failed: set = set()
        data = execution.backend_data
        if not data.get("started") or data.get("stopped"):
            return reached, failed
        for h in data["workers"].values():
            if h.done:
                continue
            if not h.alive:
                failed.add(h.key)
                continue
            try:
                h.conn.send(message)
                reached.add(h.key)
            except (BrokenPipeError, OSError):
                h.alive = False
                failed.add(h.key)
        return reached, failed

    def notify_snapshot_committed(self, execution, snapshot_id: int) -> None:
        # phase-2 fan-out: a worker that died between commit and this
        # notification is already handled by the failure path; nothing
        # to do about it here
        self.broadcast(execution, ("committed", snapshot_id))

    # -- chaos ---------------------------------------------------------------
    def inject_fault(self, execution, kind: str, worker_index: int = 0,
                     **params) -> bool:
        """Translate an abstract chaos fault into the realest failure this
        substrate can produce:

        * ``kill`` — SIGKILL the worker process (crash detection path);
        * ``stall`` — SIGSTOP it (hung detection path; ``duration_s``
          resumes it with SIGCONT, else it stays stopped until the
          supervisor SIGKILLs it or teardown resumes it);
        * ``raise`` — command the child to plant an exception inside a
          processor slice (error-exit path; ``tasklet``/``message``);
        * ``drop_ack`` / ``delay_ack`` — intercept the worker's next
          barrier ack in the coordinator (barrier timeout / late-ack
          paths; ``delay_s`` for the hold).
        """
        data = execution.backend_data
        if not data.get("started") or data.get("stopped"):
            return False
        live = [h for h in data["workers"].values()
                if h.alive and not h.done and h.proc.exitcode is None]
        if not live:
            return False
        h = sorted(live, key=lambda x: x.key)[worker_index % len(live)]
        if kind == "kill":
            try:
                os.kill(h.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, OSError):  # pragma: no cover
                return False
            return True
        if kind == "stall":
            try:
                os.kill(h.proc.pid, signal.SIGSTOP)
            except (ProcessLookupError, OSError):  # pragma: no cover
                return False
            duration = params.get("duration_s")
            resume_at = (None if duration is None
                         else _time.monotonic() + duration)
            data.setdefault("stalled", {})[h.proc.pid] = resume_at
            return True
        if kind == "raise":
            try:
                h.conn.send(("chaos_raise", params.get("tasklet"),
                             params.get("message", "chaos[raise] injected")))
            except (BrokenPipeError, OSError):  # pragma: no cover
                return False
            return True
        if kind == "drop_ack":
            data.setdefault("chaos_acks", {})[h.key] = ("drop", None)
            return True
        if kind == "delay_ack":
            data.setdefault("chaos_acks", {})[h.key] = (
                "delay", params.get("delay_s", 0.5))
            return True
        return False

    # -- telemetry -----------------------------------------------------------
    def source_start(self, execution) -> Optional[float]:
        """Earliest paced-source schedule anchor across workers (shipped
        with the final stats); the latency benchmark's t0."""
        starts = execution.backend_data.get("source_starts")
        return min(starts.values()) if starts else None
