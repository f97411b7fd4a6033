"""The port's copy of the host engine against the JAX package's.

The host engine (``core/``, ``state/``, ``runtime/supervisor.py``,
``nexmark/queries.py``) is plain Python and numpy in both packages: the
port keeps its own copy and imports nothing of ``repro``.  Each test runs
one pipeline through both packages on the same seeded stream and compares
the outputs exactly (every result event's time, key, window and value,
with multiplicity where the run has no failure) and the late-drop
counters.  No float tolerance is used: counts and sums of small integers
are exact in both.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

def _pkg(name):
    """The modules of one package that a pipeline is built from."""
    core = importlib.import_module(name + ".core")
    return dict(core=core,
                engine=importlib.import_module(name + ".core.engine"),
                nexmark=importlib.import_module(name + ".nexmark"))


def _finish(m, cluster, job, out, kill_at_result=None):
    killed = False
    for _ in range(4_000_000):
        if job.status == m["engine"].JOB_COMPLETED:
            break
        cluster.step()
        if (kill_at_result is not None and not killed
                and len(out) >= kill_at_result and job.snapshots_taken > 0):
            cluster.kill_node(cluster.node_ids[-1])
            killed = True
    assert job.status == m["engine"].JOB_COMPLETED
    if kill_at_result is not None:
        assert killed, "node was never killed — test setup broken"
    return sum(getattr(t.processor, "late_dropped", 0)
               for t in job.execution.tasklets)


def run_q5(name, disorder=0, n_nodes=1, exactly_once=False,
           kill_at_result=None, rate=60_000, total=12_000):
    """test_device_window.py's ``_run_q5`` with host placement: the result
    events as sorted ``(ts, key, window_end, value)`` tuples, and the late
    drops."""
    m = _pkg(name)
    core, nx = m["core"], m["nexmark"]
    gen = nx.NexmarkGenerator(rate=rate, n_keys=40)
    if disorder:
        gen = nx.DisorderedNexmarkGenerator(gen, max_skew_ms=disorder,
                                            seed=9)
        total = (total // gen.block) * gen.block
    cluster = core.JetCluster(n_nodes=n_nodes, cooperative_threads=2,
                              clock=core.VirtualClock(auto_step=0.001))
    out = []
    p = nx.queries.q5(
        lambda: core.PacedGeneratorSource(gen, rate=rate, max_events=total,
                                          wm_lag=disorder),
        lambda: core.CollectorSink(out), window_ms=100, slide_ms=20,
        placement="host")
    guarantee = core.GUARANTEE_EXACTLY_ONCE if exactly_once else \
        core.GUARANTEE_NONE
    job = cluster.submit(p.to_dag(), core.JobConfig(
        processing_guarantee=guarantee, snapshot_interval_s=0.02))
    drops = _finish(m, cluster, job, out, kill_at_result)
    return sorted((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                  for ev in out), drops


@pytest.mark.parametrize("disorder", [0, 40])
def test_q5_host_placement_equals_reference(disorder):
    """Ordered, and disordered by up to 40 ms with a covering watermark
    lag: the same result events, one for one, and no late drops."""
    ref, ref_drops = run_q5("repro", disorder=disorder)
    got, got_drops = run_q5("repro_torch", disorder=disorder)
    assert got == ref and len(got) > 0
    assert len(set(got)) == len(got)            # each result once
    assert got_drops == ref_drops == 0


def test_q5_host_disordered_with_short_lag_drops_as_reference():
    """A watermark lag shorter than the skew drops late events: the port
    drops exactly as many, and emits the same (incomplete) windows."""
    def run(name):
        m = _pkg(name)
        core, nx = m["core"], m["nexmark"]
        gen = nx.DisorderedNexmarkGenerator(
            nx.NexmarkGenerator(rate=60_000, n_keys=40), max_skew_ms=40,
            seed=9)
        total = (12_000 // gen.block) * gen.block
        cluster = core.JetCluster(n_nodes=1, cooperative_threads=2,
                                  clock=core.VirtualClock(auto_step=0.001))
        out = []
        p = nx.queries.q5(
            lambda: core.PacedGeneratorSource(gen, rate=60_000,
                                              max_events=total, wm_lag=5),
            lambda: core.CollectorSink(out), window_ms=100, slide_ms=20)
        job = cluster.submit(p.to_dag(), core.JobConfig())
        drops = _finish(m, cluster, job, out)
        return sorted((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                      for ev in out), drops

    ref, ref_drops = run("repro")
    got, got_drops = run("repro_torch")
    assert got == ref and len(got) > 0
    assert got_drops == ref_drops > 0


@pytest.mark.slow
def test_q5_host_exactly_once_through_kill_node():
    """Two nodes, exactly-once snapshots and a node killed after 30
    results: the port's output equals its own no-failure run and the
    reference's run through the same kill."""
    base, _ = run_q5("repro_torch", n_nodes=2)
    killed, _ = run_q5("repro_torch", n_nodes=2, exactly_once=True,
                       kill_at_result=30)
    ref, _ = run_q5("repro", n_nodes=2, exactly_once=True,
                    kill_at_result=30)
    assert set(killed) == set(base) and len(base) > 0
    assert set(killed) == set(ref)


def _journal_run(name, events, build, n_nodes=1, threads=2):
    """Run the pipeline ``build(p, core, journal, out, late_out)`` makes
    over a one-partition journal of ``events`` (a merge-read of several
    would partly re-sort a disordered stream); returns the sink's events
    and the late sink's."""
    m = _pkg(name)
    core = m["core"]
    cluster = core.JetCluster(n_nodes=n_nodes, cooperative_threads=threads,
                              clock=core.VirtualClock())
    journal = core.Journal(n_partitions=1)
    journal.extend(events)
    out, late_out = [], []
    p = core.Pipeline.create()
    build(p, core, journal, out, late_out)
    job = cluster.submit(p.to_dag())
    cluster.run_until_complete(job)
    assert job.status == m["engine"].JOB_COMPLETED
    return out, late_out


def _session_events(seed):
    rng = np.random.RandomState(seed)
    events, t = [], 0
    for _ in range(400):
        t += int(rng.randint(1, 40))
        # up to 30 ms of disorder, behind a 30 ms watermark lag
        ts = max(0, t - int(rng.randint(0, 30)))
        k = int(rng.randint(0, 6))
        events.append((ts, k, k))
    return events


@pytest.mark.parametrize("n_nodes", [1, 2])
def test_session_windows_equal_reference(n_nodes):
    """core/window.py's SessionWindowProcessor: gap-based sessions over a
    disordered stream, on one and two nodes."""
    events = _session_events(3)

    def build(p, core, journal, out, _late):
        (p.read_from(lambda: core.JournalSource(journal, wm_lag=30),
                     name="src")
           .with_key(lambda v: v)
           .window(core.session(60))
           .aggregate(core.counting())
           .write_to(lambda: core.CollectorSink(out)))

    def results(name):
        out, _ = _journal_run(name, events, build, n_nodes=n_nodes)
        return sorted((ev.ts, ev.key, ev.value.window_start,
                       ev.value.window_end, ev.value.value) for ev in out)

    ref = results("repro")
    assert results("repro_torch") == ref and len(ref) > 20


def test_allowed_lateness_refires_and_late_side_output_equal_reference():
    """core/window.py's lateness path: a disordered stream with a
    watermark lag shorter than its skew, an allowed lateness that keeps
    some late events (re-fires) and drops the rest to the late sink."""
    rng = np.random.RandomState(5)
    events = []
    for i in range(600):
        ts = max(0, i * 3 - int(rng.randint(0, 60)))
        k = "abc"[int(rng.randint(0, 3))]
        events.append((ts, k, (k, int(rng.randint(1, 10)))))

    def build(p, core, journal, out, late_out):
        (p.read_from(lambda: core.JournalSource(journal, wm_lag=10),
                     name="src")
           .with_key(lambda v: v[0])
           .window(core.sliding(40, 10))
           .allowed_lateness(25)
           .late_sink(lambda: core.CollectorSink(late_out))
           .aggregate(core.summing(lambda ev: ev.value[1]))
           .write_to(lambda: core.CollectorSink(out)))

    def results(name):
        # one accumulate instance: the sequence of firings is then
        # deterministic (test_event_time.py's lateness tests do the same)
        out, late = _journal_run(name, events, build, threads=1)
        return ([(ev.ts, ev.key, ev.value.window_end, ev.value.value)
                 for ev in out],
                sorted((ev.ts, ev.key, ev.value) for ev in late))

    ref_out, ref_late = results("repro")
    got_out, got_late = results("repro_torch")
    assert got_out == ref_out
    assert got_late == ref_late
    refired = len(ref_out) - len({(w, k) for _t, k, w, _v in ref_out})
    assert refired > 0 and len(ref_late) > 0    # both paths ran


def test_watermark_waits_for_the_frames_it_closed():
    """F6 (ROADMAP.md §3): a stage-1 accumulate closes two frames on a
    watermark, one partial for each of two queues of its partitioned
    out-edge; the first queue is full, so the flush stops there and holds
    back the second queue's partial too.  The watermark must not reach the
    second queue ahead of that partial: the combine downstream would close
    the window without it and drop it unseen (in ``backend="mp"`` a queue
    parked on a barrier fills its ring: the undercounts of F6).  The
    interleaving is built by hand, so the check is deterministic."""
    from repro_torch.core.dag import PARTITION_COUNT, Routing
    from repro_torch.core.events import Event, Watermark
    from repro_torch.core.queues import SPSCQueue
    from repro_torch.core.tasklet import (
        GUARANTEE_EXACTLY_ONCE, EdgeCollector, InQueue, ProcessorTasklet,
        SnapshotContext)
    from repro_torch.core.window import (
        AccumulateByFrameProcessor, CombineFramesProcessor, counting,
        sliding)

    wdef = sliding(40, 10)
    src = SPSCQueue(64)
    for ts, key in [(1, 1), (2, 2), (3, 2), (4, 1), (5, 2)]:
        src.offer(Event(ts, key, None))
    src.offer(Watermark(10))                   # closes frame 10 of both keys
    full, other = SPSCQueue(1), SPSCQueue(8)
    full.offer("occupied")
    p2q = [1] * PARTITION_COUNT
    p2q[hash(1) % PARTITION_COUNT] = 0         # key 1 -> the full queue
    acc = AccumulateByFrameProcessor(wdef, counting())
    t = ProcessorTasklet("acc", acc, [InQueue(src, 0)],
                         [EdgeCollector([full, other], Routing.PARTITIONED,
                                        None, p2q)],
                         SnapshotContext(GUARANTEE_EXACTLY_ONCE), "acc", 0)
    acc.init(t.outbox, None)
    for _ in range(4):
        t.call()
    assert other.poll() is None, "the watermark overtook the held partial"
    assert full.poll() == "occupied"           # the consumer catches up
    for _ in range(4):
        t.call()
    first = [full.poll(), full.poll()]
    assert first[0].value == (10, 2) and first[1] is None
    tail = []
    while (item := other.poll()) is not None:
        tail.append(item)
    assert [type(x).__name__ for x in tail] == ["Event", "Watermark"]
    assert tail[0].key == 2 and tail[0].value == (10, 3)
    assert full.poll() is None
    for _ in range(2):
        t.call()
    assert isinstance(full.poll(), Watermark)  # after key 1's partial

    # the combine of the second queue counts key 2's three events
    comb = CombineFramesProcessor(wdef, counting())
    out = SPSCQueue(16)
    c = ProcessorTasklet("comb", comb, [InQueue(SPSCQueue(8), 0)],
                         [EdgeCollector([out], Routing.ISOLATED, None)],
                         SnapshotContext(GUARANTEE_EXACTLY_ONCE), "comb", 0)
    comb.init(c.outbox, None)
    for item in tail:
        c.in_queues[0].q.offer(item)
    for _ in range(4):
        c.call()
    res = out.poll()
    assert res.value.window_end == 10 and res.value.value == 3
