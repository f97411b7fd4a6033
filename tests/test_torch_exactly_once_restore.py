"""Exactly-once through a restore from a snapshot taken after a source
finished: F9 and F10 (ROADMAP.md §3), in the port's engine.

F9: a source that has emitted its last event turns snapshot-exempt, and a
snapshot that completed afterwards carried no entry of it.  A restore from
that snapshot lost the finished instance's cursor (``("gen", p)`` of a
``PacedGeneratorSource``, ``("off", jp)`` of a ``JournalSource``) and
replayed its events into windows that already held them.  F10: a
non-source was exempt while ``complete()`` still emitted its tail, so
state kept from before the tail would let a restore emit the tail twice.

Every scenario is gated, not timed: the instances that should still be
running hold at a fixed point of their stream until the test releases
them, so one instance always finishes first, a snapshot begun after that
commits while the job still runs, and the node is killed right after the
test sees that commit.  The marks are two files in the test's directory,
which worker processes see as well as this one.  Each run is compared with
the clean run of the same stream in process: the set of results, one value
for each ``(window_end, auction)``, and the late drops.
"""

import os
import time

import pytest

pytest.importorskip("torch")

from repro_torch import core                                # noqa: E402
from repro_torch.core import engine                         # noqa: E402
from repro_torch.nexmark import NexmarkGenerator, queries   # noqa: E402

RATE = 60_000
TOTAL = 24_000
#: where held paced instances stop until released (seq)
HOLD_SEQ = 12_000
#: where held journal instances stop until released (events read)
HOLD_EVENTS = 4_000
#: journal partitions, and the share of events the short instance reads
JOURNAL_PARTITIONS = 16
SHORT_EVERY = 10
#: a bound on every run's wall time: a stuck job fails, it never hangs
DEADLINE_S = 60.0


class Marks:
    """``finished``: a source instance that read something has finished.
    ``released``: held instances go on."""

    def __init__(self, root, held: bool = True):
        self.finished = os.path.join(root, "finished")
        self.released = os.path.join(root, "released")
        if not held:
            self.release()

    def note_finished(self) -> None:
        if not os.path.exists(self.finished):
            open(self.finished, "w").close()

    def is_finished(self) -> bool:
        return os.path.exists(self.finished)

    def release(self) -> None:
        open(self.released, "w").close()

    def is_released(self) -> bool:
        return os.path.exists(self.released)


class HeldPaced(core.PacedGeneratorSource):
    """Instance 0 (``free`` of them) runs to the end of the stream; every
    other instance stops at ``HOLD_SEQ`` until released."""

    def __init__(self, marks: Marks, free: int = 1, **kw):
        super().__init__(**kw)
        self.marks = marks
        self.free = free
        self._released = False

    def complete(self) -> bool:
        if not self._released:
            self._released = self.marks.is_released()
        if self._released or self.ctx.global_index < self.free:
            done = super().complete()
            if done:
                self.marks.note_finished()
            return done
        full, self.max_events = self.max_events, HOLD_SEQ
        try:
            super().complete()
        finally:
            self.max_events = full
        return False


class HeldJournal(core.JournalSource):
    """Every instance stops after ``HOLD_EVENTS`` events until released;
    the short instance has fewer and runs dry first."""

    def __init__(self, journal, marks: Marks, **kw):
        super().__init__(journal, **kw)
        self.marks = marks
        self._released = False

    def _due_budget(self) -> int:
        budget = super()._due_budget()
        if not self._released:
            self._released = self.marks.is_released()
        if not self._released:
            budget = min(budget, max(0, HOLD_EVENTS - self._emitted))
        return budget

    def complete(self) -> bool:
        done = super().complete()
        if done and self._offsets:
            self.marks.note_finished()
        return done


def skewed_journal(cluster, threads: int = 2):
    """The stream's first ``TOTAL`` events over ``JOURNAL_PARTITIONS``
    partitions.  The instance that reads partition 0 gets one event in
    ``SHORT_EVERY`` across the whole stream, the others the rest, so it
    runs dry first while its events reach every window."""
    table = cluster.imap_service.table
    reader = {jp: (table.owner(jp), jp % threads)
              for jp in range(JOURNAL_PARTITIONS)}
    short = [jp for jp in range(JOURNAL_PARTITIONS)
             if reader[jp] == reader[0]]
    long_ = [jp for jp in range(JOURNAL_PARTITIONS) if jp not in short]
    assert len(set(reader.values())) == 2 * threads, reader
    gen = NexmarkGenerator(rate=RATE, n_keys=40)
    journal = core.Journal(n_partitions=JOURNAL_PARTITIONS)
    for seq in range(TOTAL):
        if seq % SHORT_EVERY == 0:
            jp = short[(seq // SHORT_EVERY) % len(short)]
        else:
            jp = long_[seq % len(long_)]
        journal.partitions[jp].append(gen(seq))
    return journal


def paced_source(marks):
    return lambda cluster: (lambda: HeldPaced(
        marks, gen_fn=NexmarkGenerator(rate=RATE, n_keys=40), rate=RATE,
        max_events=TOTAL))


def journal_source(marks):
    def make(cluster):
        journal = skewed_journal(cluster)
        return lambda: HeldJournal(journal, marks, rate=RATE / 4)
    return make


def q5_results(out):
    return sorted(set((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                      for ev in out))


def one_value_per_window(results):
    windows = [(w, k) for _ts, k, w, _v in results]
    return len(windows) == len(set(windows))


def drive(cluster, job, marks, kill: bool) -> None:
    """Run ``job`` to its end; with ``kill``, kill the last node right
    after the first commit of a snapshot begun once ``marks`` says a
    source instance finished, then release the held instances."""
    gate, killed = None, False
    deadline = time.monotonic() + DEADLINE_S
    while job.status not in (engine.JOB_COMPLETED, engine.JOB_FAILED):
        assert time.monotonic() < deadline, (
            gate, killed, marks.is_finished(), job.snapshots_taken,
            job.recovery_diagnostics())
        cluster.step()
        if not kill or killed:
            continue
        if gate is None and marks.is_finished():
            gate = job.execution.ssctx.requested_id + 1
        committed = cluster.snapshot_store.latest_committed(job.id)
        if gate is not None and committed is not None and committed >= gate:
            cluster.kill_node(cluster.node_ids[-1])
            killed = True
            marks.release()
    assert job.status == engine.JOB_COMPLETED, job.recovery_diagnostics()
    if kill:
        assert killed and job.restarts >= 1


def run_q5(make_source, marks, backend="inproc", kill=False):
    """Q5 over ``make_source(cluster)`` on 2 nodes x 2 threads, exactly
    once; returns the result set and the late drops."""
    clock = core.VirtualClock(auto_step=0.001) if backend == "inproc" \
        else None
    cluster = core.JetCluster(n_nodes=2, cooperative_threads=2,
                              backend=backend, clock=clock)
    out = []
    try:
        p = queries.q5(make_source(cluster), lambda: core.CollectorSink(out),
                       window_ms=100, slide_ms=20)
        job = cluster.submit(p.to_dag(), core.JobConfig(
            processing_guarantee=core.GUARANTEE_EXACTLY_ONCE,
            snapshot_interval_s=0.02))
        drive(cluster, job, marks, kill)
        drops = sum(getattr(t.processor, "late_dropped", 0)
                    for t in job.execution.tasklets)
    finally:
        cluster.shutdown()
    return q5_results(out), drops


SOURCES = {"paced": paced_source, "journal": journal_source}


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    cache = {}

    def get(kind):
        if kind not in cache:
            marks = Marks(tmp_path_factory.mktemp("clean"), held=False)
            cache[kind] = run_q5(SOURCES[kind](marks), marks)
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_restore_after_a_source_finished_inproc(clean, tmp_path, kind):
    """F9 in process, on a virtual clock: one source instance finishes,
    a snapshot commits after it, the node dies; the result equals the
    clean run's (no window counts the finished instance's events twice)."""
    marks = Marks(tmp_path)
    got, drops = run_q5(SOURCES[kind](marks), marks, kill=True)
    ref, ref_drops = clean(kind)
    assert len(ref) > 0 and one_value_per_window(ref)
    assert one_value_per_window(got)
    assert got == ref
    assert drops == ref_drops == 0


@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_restore_after_a_source_finished_mp(clean, tmp_path, kind):
    """F9 on ``backend="mp"``: the same gated scenario across 4 worker
    processes; the finished source shares its worker with live tasklets,
    so F4's abort does not apply and the snapshot commits."""
    marks = Marks(tmp_path)
    got, drops = run_q5(SOURCES[kind](marks), marks, backend="mp",
                        kill=True)
    ref, ref_drops = clean(kind)
    assert one_value_per_window(got)
    assert got == ref
    assert drops == ref_drops == 0


def test_snapshot_carries_a_finished_instance_cursor(tmp_path):
    """The snapshot that commits after instance 0 finished holds a
    ``("gen", p)`` cursor of every instance, instance 0's at the end of
    its residue class."""
    marks = Marks(tmp_path)
    cluster = core.JetCluster(n_nodes=2, cooperative_threads=2,
                              clock=core.VirtualClock(auto_step=0.001))
    p = queries.q5(paced_source(marks)(cluster),
                   lambda: core.CollectorSink([]), window_ms=100,
                   slide_ms=20)
    job = cluster.submit(p.to_dag(), core.JobConfig(
        processing_guarantee=core.GUARANTEE_EXACTLY_ONCE,
        snapshot_interval_s=0.02))
    store = cluster.snapshot_store
    gate = None
    for _ in range(200_000):
        cluster.step()
        if gate is None and marks.is_finished():
            gate = job.execution.ssctx.requested_id + 1
        sid = store.latest_committed(job.id)
        if gate is not None and sid is not None and sid >= gate:
            break
    else:
        pytest.fail("no snapshot committed after instance 0 finished")
    source = next(t.vertex_name for t in job.execution.tasklets
                  if t.is_source)
    cursors = {}
    for key, val in store.vertex_entries(job.id, sid, source):
        if key[0] == "gen":
            cursors[val[2]] = val[0]
    assert sorted(cursors) == [0, 1, 2, 3]
    assert cursors[0] >= TOTAL
    assert all(HOLD_SEQ <= c < TOTAL for i, c in cursors.items() if i)
    assert job.status == engine.JOB_RUNNING
    cluster.shutdown()


def test_window_tail_is_emitted_once_through_a_restore(tmp_path):
    """F10: branch A (a finite journal) finishes while branch B (a held
    paced stream) runs on.  A snapshot begun after A's source finished
    commits only once A's sink turned exempt, i.e. after A's windows
    emitted their tail from ``complete()``.  A restore from it must not
    emit that tail again: A's sink holds every result once, and equals
    the clean run's."""

    def build(marks, out_a, out_b):
        gen = NexmarkGenerator(rate=RATE, n_keys=40)
        journal = core.Journal(n_partitions=1)
        journal.partitions[0].extend(gen(s) for s in range(HOLD_EVENTS // 2))
        p = core.Pipeline.create()
        for src, out in (
                (lambda: HeldJournal(journal, marks, rate=RATE), out_a),
                (lambda: HeldPaced(marks, free=0, gen_fn=gen, rate=RATE,
                                   max_events=TOTAL), out_b)):
            (p.read_from(src, name="bids")
              .filter(queries.is_bid)
              .with_key(queries.bid_auction)
              .window(core.sliding(100, 20))
              .aggregate(core.counting())
              .write_to(lambda out=out: core.CollectorSink(out)))
        return p

    def run(marks, kill):
        cluster = core.JetCluster(n_nodes=2, cooperative_threads=2,
                                  clock=core.VirtualClock(auto_step=0.001))
        out_a, out_b = [], []
        job = cluster.submit(build(marks, out_a, out_b).to_dag(),
                             core.JobConfig(
                                 processing_guarantee=core
                                 .GUARANTEE_EXACTLY_ONCE,
                                 snapshot_interval_s=0.02))
        drive(cluster, job, marks, kill)
        cluster.shutdown()
        return ([(ev.ts, ev.key, ev.value.window_end, ev.value.value)
                 for ev in out_a], q5_results(out_b))

    (tmp_path / "clean").mkdir()
    ref_a, ref_b = run(Marks(tmp_path / "clean", held=False), kill=False)
    got_a, got_b = run(Marks(tmp_path), kill=True)
    assert len(ref_a) > 0 and len(set(ref_a)) == len(ref_a)
    assert sorted(got_a) == sorted(ref_a)       # every tail result once
    assert got_b == ref_b and one_value_per_window(got_b)


class _Stub:
    """A tasklet as ``SnapshotContext`` sees it."""

    def __init__(self, exempt=False):
        self.is_snapshot_exempt = exempt
        self.vertex_name = "v"
        self.global_index = 0


def test_an_ack_ahead_of_begin_completes_the_snapshot():
    """F11: in a worker process whose sources have finished, a tasklet
    aligns on a barrier from other workers and acks it before the worker
    begins that snapshot.  ``begin`` must count that ack, or the local
    snapshot never completes and every later one queues behind it."""
    from repro_torch.core.tasklet import SnapshotContext
    done = []
    ctx = SnapshotContext(core.GUARANTEE_EXACTLY_ONCE)
    ctx.on_complete = done.append
    live, finished = _Stub(), _Stub(exempt=True)
    ctx.tasklets = [live, finished]
    ctx.begin(1)
    ctx.ack(1, live)
    ctx.ack(2, live)            # barrier 2 overtook the command to begin it
    ctx.begin(2)
    assert done == [1, 2]
    ctx.ack(1, live)            # a stale ack changes nothing
    ctx.begin(3)
    assert done == [1, 2] and ctx.completed_id == 2


def test_worker_ack_ships_only_its_own_snapshot_entries():
    """F11: a worker's buffered entries of a later snapshot stay for that
    snapshot's ack; entries of an earlier, aborted one are dropped."""
    from repro_torch.runtime.worker_proc import _BufferWriter
    w = _BufferWriter()
    for sid in (1, 2, 3):
        w.put(sid, "v", ("k", sid), [sid], pid=0)
    assert [e[0] for e in w.take(2)] == [2]
    assert [e[0] for e in w.take(3)] == [3]
    assert w.take(3) == []
