"""Self-healing in the port: failures the engine did not schedule.

tests/test_self_healing.py's cases for the port's ``mp`` backend: a
worker SIGKILLed, raising, hung (SIGSTOPped) or losing its barrier ack
mid-run, with no API call, is classified by the supervisor, healed from
the last committed snapshot, and the exactly-once result set equals the
clean run's.  Every healed run is compared with the clean ``mp`` run
and with the clean in-process run on a virtual clock (equal to the JAX
package's), never with a speed or with zero drops.  The barrier
protocol's abort rules (``MpSnapshotContext``), the supervisor's
classification and the shutdown escalation are held to the JAX
package's on the same scripted inputs.
"""

import importlib
import multiprocessing as mp
import signal
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    CollectorSink, GUARANTEE_EXACTLY_ONCE, GUARANTEE_NONE, JetCluster,
    JobConfig, PacedGeneratorSource, VirtualClock)
from repro_torch.core.backend import (  # noqa: E402
    FAILURE_CRASHED, FAILURE_ERROR, FAILURE_HUNG)
from repro_torch.core.engine import (  # noqa: E402
    JOB_COMPLETED, JOB_FAILED, RestartPolicy)
from repro_torch.nexmark import NexmarkGenerator, queries  # noqa: E402
from repro_torch.runtime.supervisor import WorkerSupervisor  # noqa: E402
from repro_torch.runtime import worker_proc  # noqa: E402
from repro_torch.runtime.worker_proc import (  # noqa: E402
    MpSnapshotContext, MultiprocessBackend, _kill_handle_hard)

RATE = 60_000
# 0.8 s of paced event time: a fault injected once the first snapshot
# committed finds live mid-run workers
TOTAL = 48_000


def _dedup(out):
    return sorted(set((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                      for ev in out))


def _run_q5_fault(backend, fault=None, fault_at=200,
                  guarantee=GUARANTEE_EXACTLY_ONCE, restart_policy=None,
                  barrier_timeout_s=5.0, expect_completed=True,
                  fault_params=None, gate="commit"):
    """Exactly-once Q5 on 2 nodes x 2 threads; one fault through the
    backend's chaos seam once the sink holds ``fault_at`` results and a
    snapshot committed (``gate="commit"``) or was requested
    (``gate="barrier"``, for ack faults).  ``inproc`` runs on a virtual
    clock.  Returns (deduplicated results, job, late drops)."""
    clock = VirtualClock(auto_step=0.001) if backend == "inproc" else None
    cluster = JetCluster(n_nodes=2, cooperative_threads=2, backend=backend,
                         clock=clock)
    out = []
    p = queries.q5(
        lambda: PacedGeneratorSource(NexmarkGenerator(rate=RATE, n_keys=40),
                                     rate=RATE, max_events=TOTAL),
        lambda: CollectorSink(out), window_ms=100, slide_ms=20)
    job = cluster.submit(p.to_dag(), JobConfig(
        processing_guarantee=guarantee, snapshot_interval_s=0.1,
        restart_policy=restart_policy,
        barrier_timeout_s=barrier_timeout_s))
    injected = False
    deadline = time.monotonic() + 120.0
    try:
        while job.status not in (JOB_COMPLETED, JOB_FAILED):
            assert time.monotonic() < deadline, job.recovery_diagnostics()
            cluster.step()
            if (fault is not None and not injected
                    and job.execution is not None
                    and len(out) >= fault_at
                    and (job.snapshots_taken > 0
                         or (gate == "barrier"
                             and job.execution.ssctx.requested_id >= 1)
                         or guarantee == GUARANTEE_NONE)):
                injected = cluster.backend.inject_fault(
                    job.execution, fault, 0, **(fault_params or {}))
        if fault is not None:
            assert injected, "the fault was never injected"
        if expect_completed:
            assert job.status == JOB_COMPLETED, job.recovery_diagnostics()
        drops = 0
        if job.execution is not None:
            drops = sum(getattr(t.processor, "late_dropped", 0)
                        for t in job.execution.tasklets)
    finally:
        cluster.shutdown()
    return _dedup(out), job, drops


@pytest.fixture(scope="module")
def clean():
    """The clean exactly-once run: ``mp`` equal to in-process, and the
    in-process run equal to the JAX package's."""
    results, _, drops = _run_q5_fault("mp")
    inproc, _, inproc_drops = _run_q5_fault("inproc")
    assert results == inproc and results
    assert drops == inproc_drops
    ref = importlib.import_module("repro.core")
    ref_nx = importlib.import_module("repro.nexmark")
    ref_engine = importlib.import_module("repro.core.engine")
    cluster = ref.JetCluster(n_nodes=2, cooperative_threads=2,
                             clock=ref.VirtualClock(auto_step=0.001))
    out = []
    p = ref_nx.queries.q5(
        lambda: ref.PacedGeneratorSource(
            ref_nx.NexmarkGenerator(rate=RATE, n_keys=40), rate=RATE,
            max_events=TOTAL),
        lambda: ref.CollectorSink(out), window_ms=100, slide_ms=20)
    job = cluster.submit(p.to_dag(), ref.JobConfig(
        processing_guarantee=ref.GUARANTEE_EXACTLY_ONCE,
        snapshot_interval_s=0.1))
    cluster.run_until_complete(job)
    assert job.status == ref_engine.JOB_COMPLETED
    assert _dedup(out) == results
    return results, drops


# --------------------------------------------------------------- detection --

def test_mp_sigkill_detected_and_healed(clean):
    results, job, drops = _run_q5_fault("mp", fault="kill")
    assert results == clean[0] and drops == clean[1]
    assert job.auto_restarts >= 1
    crashed = [f for f in job.failures if f.kind == FAILURE_CRASHED]
    assert crashed and crashed[0].exitcode is not None \
        and crashed[0].exitcode < 0


def test_mp_error_exit_detected_with_traceback(clean):
    results, job, _ = _run_q5_fault(
        "mp", fault="raise", fault_params={"message": "chaos-injected"})
    assert results == clean[0]
    assert job.auto_restarts >= 1
    errors = [f for f in job.failures if f.kind == FAILURE_ERROR]
    assert errors and "chaos-injected" in errors[0].detail


def test_kill_right_after_a_commit_keeps_the_results_before_it(
        clean, monkeypatch):
    """F7 (ROADMAP.md §3): a worker killed after its snapshot committed
    took with it the results its sinks had collected before the barrier
    but not yet shipped (they go out every ``_RESULT_SHIP_S``), and the
    restore from that snapshot never replays them.  Shipping held back
    (the interval made huge; the forked workers inherit it) makes the
    interleaving certain: the results before the barrier must ship with
    the ack."""
    monkeypatch.setattr(worker_proc, "_RESULT_SHIP_S", 1e9)
    results, job, _ = _run_q5_fault("mp", fault="kill", fault_at=0)
    assert job.auto_restarts >= 1
    assert results == clean[0]


def test_mp_hung_worker_detected_and_healed(clean):
    results, job, _ = _run_q5_fault(
        MultiprocessBackend(heartbeat_timeout_s=1.0), fault="stall")
    assert results == clean[0]
    assert job.auto_restarts >= 1
    assert FAILURE_HUNG in [f.kind for f in job.failures]


def test_mp_dropped_ack_aborts_snapshot_and_completes(clean):
    results, job, _ = _run_q5_fault(
        "mp", fault="drop_ack", barrier_timeout_s=0.4, fault_at=0,
        gate="barrier")
    assert results == clean[0]
    assert job.snapshots_aborted >= 1
    assert job.auto_restarts == 0           # nobody died


def test_mp_late_ack_after_abort_is_ignored(clean):
    results, job, _ = _run_q5_fault(
        "mp", fault="delay_ack", barrier_timeout_s=0.3, fault_at=0,
        gate="barrier", fault_params={"delay_s": 0.8})
    assert results == clean[0]
    assert job.snapshots_aborted >= 1


def test_inproc_injected_exception_healed(clean):
    results, job, drops = _run_q5_fault("inproc", fault="raise")
    assert results == clean[0] and drops == clean[1]
    assert job.auto_restarts >= 1
    assert FAILURE_ERROR in [f.kind for f in job.failures]


@pytest.mark.parametrize("backend", ["inproc", "mp"])
def test_restart_budget_exhausted_is_terminal(backend):
    _, job, _ = _run_q5_fault(backend, fault="kill",
                              restart_policy=RestartPolicy(max_restarts=0),
                              expect_completed=False)
    assert job.status == JOB_FAILED
    assert job.auto_restarts == 0 and job.failures


def test_mp_no_guarantee_detected_failure_fails_fast():
    _, job, _ = _run_q5_fault("mp", fault="kill", guarantee=GUARANTEE_NONE,
                              expect_completed=False)
    assert job.status == JOB_FAILED
    assert job.auto_restarts == 0


# ---------------------------------------------------------- barrier aborts --

class _FakeBackend:
    def __init__(self, reached=(), failed=()):
        self.reached, self.failed = set(reached), set(failed)
        self.finished = set()
        self.sent = []

    def broadcast(self, execution, message):
        self.sent.append(message)
        return set(self.reached), set(self.failed)

    def finished_workers(self, execution):
        return set(self.finished)


def _ctx(name, reached=(), failed=(), timeout=None):
    wp = importlib.import_module(name + ".runtime.worker_proc")
    ctx = wp.MpSnapshotContext(GUARANTEE_EXACTLY_ONCE, store_writer=None)
    ctx.backend = _FakeBackend(reached, failed)
    ctx.execution = None
    ctx.ack_timeout_s = timeout
    committed = []
    ctx.on_complete = committed.append
    return ctx, committed


def _script(ctx, committed, ops):
    """Apply scripted protocol events; returns the observable state after
    each."""
    trace = []
    for op in ops:
        if op[0] == "begin":
            ctx.begin(op[1])
        elif op[0] == "ack":
            ctx.worker_ack(op[1], op[2], list(op[3]))
        elif op[0] == "gone":
            ctx.worker_gone(op[1], crashed=op[2])
        elif op[0] == "abort":
            ctx.abort("scripted")
        trace.append((ctx.requested_id, ctx.completed_id, ctx.aborted_count,
                      list(committed), sorted(ctx._await),
                      list(ctx._entries)))
    return trace


_W0, _W1 = (0, 0), (0, 1)
_SCRIPTS = {
    "broken_pipe": ({_W0}, {_W1}, [("begin", 7),
                                   ("ack", _W0, 7, [(7, "v", "k", 1, 0, 0)])]),
    "death_mid_barrier": ({_W0, _W1}, (), [
        ("begin", 1), ("ack", _W0, 1, [(1, "v", "k", 1, 0, 0)]),
        ("gone", _W1, True), ("begin", 2), ("ack", _W0, 2, []),
        ("ack", _W1, 2, [])]),
    "stale_and_double": ({_W0, _W1}, (), [
        ("begin", 3), ("ack", _W0, 2, [(2, "v", "k", 1, 0, 0)]),
        ("abort",), ("abort",), ("ack", _W1, 3, []), ("begin", 4),
        ("ack", _W1, 4, [(4, "v", "k", 2, 0, 0)]), ("ack", _W0, 4, [])]),
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_barrier_protocol_equals_the_reference(script):
    """The same scripted broadcasts, acks, deaths and aborts through the
    port's and the JAX package's ``MpSnapshotContext``: the same commits,
    aborts and buffered entries after every event (a worker that finishes
    holding a barrier is where they part: the next test)."""
    reached, failed, ops = _SCRIPTS[script]
    port = _script(*_ctx("repro_torch", reached, failed), ops)
    ref = _script(*_ctx("repro", reached, failed), ops)
    assert port == ref


def test_finished_worker_aborts_the_snapshot():
    """ROADMAP.md §3, F4: a worker that finishes its data plane holding an
    un-acked barrier, or that finished before the barrier, cannot add its
    final state, so the snapshot aborts (the reference exempts it and
    commits without that state); the last committed snapshot stays the
    one to restore."""
    ctx, committed = _ctx("repro_torch", reached={_W0, _W1})
    ctx.begin(1)
    ctx.worker_ack(_W0, 1, [(1, "v", "k", 1, 0, 0)])
    ctx.worker_gone(_W1, crashed=False)
    assert committed == [] and ctx.aborted_count == 1
    assert ctx.completed_id == 1 and ctx._entries == []
    ref, ref_committed = _ctx("repro", reached={_W0, _W1})
    ref.begin(1)
    ref.worker_ack(_W0, 1, [(1, "v", "k", 1, 0, 0)])
    ref.worker_gone(_W1, crashed=False)
    assert ref_committed == [1]                 # the reference commits
    # a worker already finished: no barrier is sent, the snapshot aborts
    ctx.backend.finished = {_W1}
    ctx.begin(2)
    assert ctx.backend.sent == [("snapshot", 1)]
    assert committed == [] and ctx.aborted_count == 2
    ctx.backend.finished = set()
    ctx.begin(3)
    ctx.worker_ack(_W0, 3, [])
    ctx.worker_ack(_W1, 3, [])
    assert committed == [3]


def test_broadcast_broken_pipe_aborts_inflight():
    ctx, committed = _ctx("repro_torch", reached={_W0}, failed={_W1})
    ctx.begin(7)
    assert ctx.aborted_count == 1 and ctx.completed_id == 7
    assert committed == []
    ctx.worker_ack(_W0, 7, [(7, "v", "k", 1, 0, 0)])
    assert committed == [] and ctx._entries == []


def test_worker_death_mid_barrier_aborts_then_next_commits():
    ctx, committed = _ctx("repro_torch", reached={_W0, _W1})
    ctx.begin(1)
    ctx.worker_ack(_W0, 1, [(1, "v", "k", 1, 0, 0)])
    ctx.worker_gone(_W1, crashed=True)
    assert ctx.aborted_count == 1 and committed == []
    ctx.begin(2)
    ctx.worker_ack(_W0, 2, [])
    ctx.worker_ack(_W1, 2, [])
    assert committed == [2] and ctx.aborted_count == 1


def test_barrier_ack_deadline_aborts():
    ctx, committed = _ctx("repro_torch", reached={_W0}, timeout=0.01)
    ctx.begin(3)
    assert not ctx.check_timeout()
    time.sleep(0.03)
    assert ctx.check_timeout()
    assert ctx.aborted_count == 1 and committed == []
    assert not ctx.check_timeout()


def test_mp_abort_retires_ongoing_snapshot_storage():
    """An aborted snapshot's IMap storage is destroyed at abort time."""
    from repro_torch.state import IMapService, SnapshotStore
    store = SnapshotStore(IMapService([0], partition_count=8))
    writer = store.writer("jobA")
    ctx = MpSnapshotContext(GUARANTEE_EXACTLY_ONCE, store_writer=writer)
    ctx.backend = _FakeBackend(reached={_W0, _W1})
    ctx.execution = None
    committed = []
    ctx.on_complete = committed.append
    ctx.begin(7)
    writer.put(7, "v", "k", 123, 0)
    assert store.size("jobA", 7) == 1
    ctx.abort("worker died holding its barrier")
    assert ctx.aborted_count == 1 and committed == []
    assert store.size("jobA", 7) == 0
    ctx.begin(8)
    ctx.worker_ack(_W0, 8, [(8, "v", "k", 1, 0, 0)])
    ctx.worker_ack(_W1, 8, [])
    assert committed == [8] and store.size("jobA", 8) == 1


# -------------------------------------------------------------- supervisor --

def _handle(key, exitcode=None, pid=4_000_000, done=False):
    return SimpleNamespace(key=key, done=done,
                           proc=SimpleNamespace(exitcode=exitcode, pid=pid))


def test_supervisor_classifies_exitcodes_as_the_reference():
    def classify(name):
        sup_mod = importlib.import_module(name + ".runtime.supervisor")
        sup = sup_mod.WorkerSupervisor(heartbeat_timeout_s=5.0)
        handles = [_handle((0, 0), exitcode=-9), _handle((0, 1), exitcode=3),
                   _handle((1, 0), exitcode=-9, done=True),
                   _handle((1, 1), exitcode=None)]
        for h in handles:
            sup.worker_started(h.key, now=0.0)
        first = sorted((f.kind, f.key) for f in sup.check(handles, now=1.0))
        return first, sup.check(handles, now=2.0)

    port = classify("repro_torch")
    assert port == classify("repro")
    assert port[0] == sorted([(FAILURE_CRASHED, (0, 0)),
                              (FAILURE_ERROR, (0, 1))])
    assert port[1] == []


def test_supervisor_kills_hung_worker():
    proc = mp.get_context("fork").Process(target=time.sleep, args=(60,))
    proc.start()
    try:
        sup = WorkerSupervisor(heartbeat_timeout_s=0.5)
        h = SimpleNamespace(key=(0, 0), done=False, proc=proc)
        sup.worker_started(h.key, now=0.0)
        sup.heartbeat(h.key, now=1.0)
        assert [f.kind for f in sup.check([h], now=10.0)] == [FAILURE_HUNG]
        proc.join(timeout=5.0)
        assert proc.exitcode == -signal.SIGKILL
    finally:
        if proc.is_alive():     # pragma: no cover - cleanup on failure
            proc.kill()
            proc.join()


def _ignore_sigterm_and_sleep():
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    while True:
        time.sleep(0.1)


def test_stop_escalates_to_sigkill_on_stuck_worker():
    proc = mp.get_context("fork").Process(target=_ignore_sigterm_and_sleep)
    proc.start()
    try:
        time.sleep(0.2)
        proc.terminate()
        proc.join(timeout=1.0)
        assert proc.exitcode is None
        _kill_handle_hard(proc)
        assert proc.exitcode == -signal.SIGKILL
    finally:
        if proc.is_alive():     # pragma: no cover - cleanup on failure
            proc.kill()
            proc.join()
