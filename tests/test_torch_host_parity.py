"""The port's copies of the host surfaces against the JAX package's.

``nexmark/queries.py`` (q1, q2, q3, q4, q5 with a global max, q7, q8,
q11, q12, q13), ``core/queues.py``, ``core/backpressure.py``, the
collectors of ``core/tasklet.py`` and ``state/`` are plain Python in both
packages.  Each case builds its inputs once, from a fixed seed or from the
literal data of the reference test it names, runs them through ``repro``
and through ``repro_torch``, and compares the outputs exactly: result
events (time, key, window and value, with multiplicity), queue contents
and return values, link credits and windows, partition owners, replica
placement and IMap contents.  The one float output, q4's average price,
is compared within a relative 1e-12.  Pipelines run on a virtual clock.
Objects of either package are compared through :func:`plain`, which
reduces them to tuples of their slots.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

PACKAGES = ("repro", "repro_torch")


def pkg(name):
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        core=mod("core"), queues=mod("core.queues"),
        backpressure=mod("core.backpressure"), events=mod("core.events"),
        tasklet=mod("core.tasklet"), dag=mod("core.dag"),
        processor=mod("core.processor"), watermark=mod("core.watermark"),
        state=mod("state"), nexmark=mod("nexmark"),
        queries=mod("nexmark.queries"), generator=mod("nexmark.generator"),
        model=mod("nexmark.model"))


def plain(x):
    """A package-independent value: containers as tuples, objects as their
    class name and slot values."""
    if isinstance(x, (bool, int, float, str, bytes, type(None))):
        return x
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted(((plain(k), plain(v)) for k, v in x.items()),
                            key=repr))
    if hasattr(x, "__dict__"):
        return (type(x).__name__, plain(vars(x)))
    slots = [s for c in type(x).__mro__ for s in getattr(c, "__slots__", ())]
    return (type(x).__name__,) + tuple(plain(getattr(x, s)) for s in slots)


def both(fn, *args):
    """``fn(package, *args)`` for the reference and the port."""
    return [fn(pkg(name), *args) for name in PACKAGES]


def run_job(m, pipeline, n_nodes):
    cluster = m.core.JetCluster(n_nodes=n_nodes, cooperative_threads=2,
                                clock=m.core.VirtualClock())
    job = cluster.submit(pipeline.to_dag())
    cluster.run_until_complete(job)
    cluster.shutdown()


# ---------------------------------------------------------------------------
# NEXMark queries (tests/test_nexmark.py, tests/test_nexmark_extended.py)
# ---------------------------------------------------------------------------

def _q1(m, j, out):
    return m.queries.q1(lambda: m.core.JournalSource(j()),
                        lambda: m.core.CollectorSink(out))


def _q2(m, j, out):
    return m.queries.q2(lambda: m.core.JournalSource(j()),
                        lambda: m.core.CollectorSink(out), mod=7)


def _q5_global_max(m, j, out):
    return m.queries.q5(lambda: m.core.JournalSource(j()),
                        lambda: m.core.CollectorSink(out), window_ms=100,
                        slide_ms=50, with_global_max=True)


def _q8(m, j, out):
    j1, j2 = j(), j(1)
    return m.queries.q8(lambda: m.core.JournalSource(j1),
                        lambda: m.core.JournalSource(j2),
                        lambda: m.core.CollectorSink(out), window_ms=200,
                        slide_ms=100)


def _q13(m, j, out):
    side = [m.model.Auction(i, i + 1, 0, 100, 10_000, 0)
            for i in range(0, 50, 2)]
    return m.queries.q13(lambda: m.core.JournalSource(j()),
                         lambda: m.core.ListSource(side),
                         lambda: m.core.CollectorSink(out))


def _q3(m, j, out):
    j1, j2 = j(), j(1)
    return m.queries.q3(lambda: m.core.JournalSource(j1),
                        lambda: m.core.JournalSource(j2),
                        lambda: m.core.CollectorSink(out),
                        states=("OR", "ID", "CA"), category=0)


def _q4(m, j, out):
    j1, j2 = j(), j(1)
    return m.queries.q4(lambda: m.core.JournalSource(j1),
                        lambda: m.core.JournalSource(j2),
                        lambda: m.core.CollectorSink(out), window_ms=100)


def _q7(m, j, out):
    return m.queries.q7(lambda: m.core.JournalSource(j()),
                        lambda: m.core.CollectorSink(out), window_ms=50)


#: query -> (pipeline, nodes, events, auction keys): the reference tests'
#: settings (test_nexmark.py: 2 000 events over 50 keys; the extended
#: file: 3 000 over 40 on 2 nodes)
QUERIES = {
    "q1": (_q1, 1, 2000, 50),
    "q2": (_q2, 1, 2000, 50),
    "q5_global_max": (_q5_global_max, 2, 2000, 50),
    "q8": (_q8, 1, 2000, 50),
    "q13": (_q13, 2, 2000, 50),
    "q3": (_q3, 2, 3000, 40),
    "q4": (_q4, 2, 3000, 40),
    "q7": (_q7, 2, 3000, 40),
}


def nexmark_query(m, name):
    build, n_nodes, n_events, n_keys = QUERIES[name]
    gen = m.nexmark.NexmarkGenerator(rate=10_000, n_keys=n_keys)
    journals = {}

    def journal(i=0):
        # one journal per source, each filled once, shared by its instances
        if i not in journals:
            journals[i] = m.core.Journal(n_partitions=8)
            m.generator.fill_journal(journals[i], gen, n_events)
        return journals[i]

    out = []
    run_job(m, build(m, journal, out), n_nodes)
    return ([plain(gen(i)) for i in range(n_events)],
            sorted((plain(ev) for ev in out), key=repr))


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_nexmark_query_equals_reference(query):
    (ref_in, ref), (got_in, got) = both(nexmark_query, query)
    assert got_in == ref_in
    assert len(ref) > 0
    if query != "q4":
        assert got == ref
        return
    # q4's value is a float average: same keys, values within 1e-12
    assert [(ts, key, wr[:3]) for _e, ts, key, wr in got] == \
        [(ts, key, wr[:3]) for _e, ts, key, wr in ref]
    assert [wr[3] for *_, wr in got] == pytest.approx(
        [wr[3] for *_, wr in ref], rel=1e-12)


def q11_sessions(m, seed, disordered):
    """tests/test_event_time.py::test_q11_sessions_disordered_equals_ordered:
    sessions of bids per bidder (gap 25 ms) over 4 whole blocks, ordered or
    shuffled by up to 60 ms behind a covering watermark lag."""
    gen = m.nexmark.NexmarkGenerator(rate=10_000, n_keys=10)
    dis = m.nexmark.DisorderedNexmarkGenerator(gen, max_skew_ms=60,
                                               seed=seed)
    n = 4 * dis.block
    events = [(dis if disordered else gen)(i) for i in range(n)]
    journal = m.core.Journal(n_partitions=1)
    journal.extend(events)
    out = []
    p = m.queries.q11(lambda: m.core.JournalSource(
                          journal, wm_lag=60 if disordered else 0),
                      lambda: m.core.CollectorSink(out), gap_ms=25)
    run_job(m, p, 2)
    return sorted((ev.value.key, ev.value.window_start,
                   ev.value.window_end, ev.value.value) for ev in out)


@pytest.mark.parametrize("seed", [0, 7])
def test_q11_sessions_equal_reference(seed):
    ref_o, got_o = both(q11_sessions, seed, False)
    ref_d, got_d = both(q11_sessions, seed, True)
    assert got_o == ref_o and len(ref_o) > 0
    assert got_d == ref_d
    assert got_d == got_o


def q12_per_bidder(m):
    """tests/test_event_time.py::test_q12_processing_time_windows_count_all_bids:
    per-bidder totals over processing-time windows (window bounds follow
    arrival, so only the totals are compared)."""
    gen = m.nexmark.NexmarkGenerator(rate=10_000, n_keys=25)
    events = [gen(i) for i in range(2000)]
    journal = m.core.Journal(n_partitions=8)
    journal.extend(events)
    out = []
    p = m.queries.q12(lambda: m.core.JournalSource(journal),
                      lambda: m.core.CollectorSink(out), window_ms=50)
    run_job(m, p, 2)
    per_key = {}
    for ev in out:
        _fend, key, count = ev.value
        per_key[key] = per_key.get(key, 0) + count
    oracle = {}
    for _t, _k, v in events:
        if isinstance(v, m.model.Bid):
            oracle[v.bidder] = oracle.get(v.bidder, 0) + 1
    return per_key, oracle


def test_q12_counts_every_bid_once_as_reference():
    (ref, ref_oracle), (got, oracle) = both(q12_per_bidder)
    assert oracle == ref_oracle
    assert got == ref == oracle


# ---------------------------------------------------------------------------
# SPSC queues (tests/test_hot_path_batching.py, the queue invariants of
# tests/test_property_invariants.py)
# ---------------------------------------------------------------------------

def spsc_literal(m):
    """The reference tests' wraparound, partial acceptance and poll_many
    sequences; every return value and poll in order."""
    Q, trace = m.queues.SPSCQueue, []
    q = Q(8)
    trace += [q.offer_many([1, 2, 3, 4, 5, 6]), [q.poll() for _ in range(5)],
              q.offer_many([7, 8, 9, 10, 11, 12, 13]), q.is_full(),
              q.offer_many([99]), [q.poll() for _ in range(8)], q.poll()]
    q = Q(4)
    trace += [q.offer_many(list(range(10))), len(q), q.poll(),
              q.offer_many(list(range(10)), 4, 6),
              [q.poll() for _ in range(4)]]
    q = Q(4)
    q.offer_many([1, 2, 3])
    trace += [q.poll_many(2)]
    q.offer_many([4, 5, 6])
    trace += [q.poll_many(10), q.poll_many(1), list(q._buf)]
    return trace


def test_spsc_bulk_ops_equal_reference():
    ref, got = both(spsc_literal)
    assert got == ref


def spsc_random(m, seed):
    """A seeded interleaving of offer, offer_many (with start/end), poll
    and poll_many against a list model: FIFO and capacity hold, and the
    trace of return values is recorded."""
    rng = np.random.RandomState(seed)
    cap = int(rng.randint(1, 17))
    q, model, trace, nxt = m.queues.SPSCQueue(cap), [], [], 0
    for _ in range(300):
        op = rng.randint(4)
        if op == 0:
            ok = q.offer(nxt)
            assert ok == (len(model) < cap)
            model += [nxt] if ok else []
            trace.append(ok)
            nxt += 1
        elif op == 1:
            items = list(range(nxt, nxt + int(rng.randint(0, 12))))
            start = int(rng.randint(0, len(items) + 1))
            n = q.offer_many(items, start)
            assert n == min(len(items) - start, cap - len(model))
            model += items[start:start + n]
            trace.append(n)
            nxt += len(items)
        elif op == 2:
            got = q.poll()
            assert got == (model.pop(0) if model else None)
            trace.append(got)
        else:
            k = int(rng.randint(0, 6))
            got = q.poll_many(k)
            assert list(got) == model[:k]
            del model[:k]
            trace.append(list(got))
        assert len(q) == len(model) and q.is_full() == (len(model) == cap)
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spsc_random_ops_equal_reference(seed):
    ref, got = both(spsc_random, seed)
    assert got == ref


def poll_prefix_trace(m):
    """tests/test_hot_path_batching.py's poll_prefix cases: data runs stop
    at a control item; a leading control item comes alone; the limit
    bounds the run and leaves control beyond it."""
    ev, Q = m.events, m.queues.SPSCQueue
    trace = []
    q = Q(16)
    for item in (ev.Event(1, "a", 1), ev.Event(2, "b", 2), ev.Watermark(5),
                 ev.Event(3, "c", 3)):
        q.offer(item)
    trace += [q.poll_prefix(16), q.poll_prefix(16), q.is_empty()]
    q = Q(16)
    q.offer(ev.Barrier(1))
    q.offer(ev.Event(1, "a", 1))
    trace += [q.poll_prefix(16)]
    q = Q(16)
    for i in range(6):
        q.offer(ev.Event(i, "k", i))
    q.offer(ev.DONE)
    trace += [q.poll_prefix(4), q.poll_prefix(4)]
    return plain(trace)


def test_poll_prefix_with_control_items_equals_reference():
    ref, got = both(poll_prefix_trace)
    assert got == ref


def link_bulk_trace(m):
    """tests/test_hot_path_batching.py::test_network_link_bulk_ops_roundtrip."""
    ev = m.events
    clock = m.core.VirtualClock()
    link = m.backpressure.NetworkLink(clock, latency_s=0.01,
                                      initial_window=8)
    items = [ev.Event(i, "k", i) for i in range(6)] + [ev.Watermark(6)]
    trace = [link.offer_many(items),
             link.offer_many([ev.Event(9, "k", 9), ev.Event(10, "k", 10)])]
    link.pump()
    trace.append(link.poll_prefix(16))
    clock.advance(0.02)
    link.pump()
    trace.append(link.poll_prefix(16))
    return plain(trace)


def test_network_link_bulk_ops_equal_reference():
    ref, got = both(link_bulk_trace)
    assert got == ref


# ---------------------------------------------------------------------------
# Edge collectors (tests/test_hot_path_batching.py)
# ---------------------------------------------------------------------------

def partitioned_offers(m, n_queues):
    """500 keyed events through a partitioned collector, once in bulk and
    once item by item: what each queue holds."""
    ev, Q, PC = m.events, m.queues.SPSCQueue, m.dag.PARTITION_COUNT
    items = [ev.Event(i, f"k{i % 17}", i) for i in range(500)]
    out = []
    for bulk in (True, False):
        queues = [Q(1024) for _ in range(n_queues)]
        c = m.tasklet.EdgeCollector(queues, m.dag.Routing.PARTITIONED, None,
                                    [pid % n_queues for pid in range(PC)])
        if bulk:
            assert c.offer_many(items) == 500
        else:
            assert all(c.offer(it) for it in items)
        out.append(plain([q.poll_many(1024) for q in queues]))
    return out


@pytest.mark.parametrize("n_queues", [2, 3])
def test_partitioned_offer_many_equals_reference(n_queues):
    (ref_bulk, ref_item), (got_bulk, got_item) = both(partitioned_offers,
                                                      n_queues)
    assert got_bulk == got_item == ref_bulk == ref_item


def full_destination(m):
    """A bulk offer stops at the first item for a full queue."""
    ev, Q, PC = m.events, m.queues.SPSCQueue, m.dag.PARTITION_COUNT
    queues = [Q(4), Q(1024)]
    p2q = [pid % 2 for pid in range(PC)]
    c = m.tasklet.EdgeCollector(queues, m.dag.Routing.PARTITIONED,
                                lambda e: e.key, p2q)
    key0 = next(k for k in range(100) if p2q[hash(k) % PC] == 0)
    accepted = c.offer_many([ev.Event(i, key0, i) for i in range(10)])
    return accepted, len(queues[0]), len(queues[1])


def test_partitioned_offer_many_at_a_full_destination_equals_reference():
    ref, got = both(full_destination)
    assert got == ref == (4, 4, 0)


def fanout_flush(m):
    """tests/test_hot_path_batching.py::test_fanout_flush_batched_equivalence:
    a source interleaving watermarks fans out to a keyed edge of two
    8-slot queues and a 4-slot isolated queue; what each queue saw."""
    ev, Q, PC = m.events, m.queues.SPSCQueue, m.dag.PARTITION_COUNT
    items = []
    for i in range(300):
        items.append(ev.Event(i, i % 7, i))
        if i % 31 == 30:
            items.append(ev.Watermark(i))

    class Src(m.processor.Processor):
        def __init__(self):
            self._i = 0

        def complete(self):
            n = 0
            while self._i < len(items) and n < 16:
                if not self.outbox.offer(items[self._i]):
                    return False
                self._i += 1
                n += 1
            return self._i >= len(items)

    qs_a = [Q(8), Q(8)]
    col_a = m.tasklet.EdgeCollector(qs_a, m.dag.Routing.PARTITIONED, None,
                                    [pid % 2 for pid in range(PC)])
    q_b = Q(4)
    col_b = m.tasklet.EdgeCollector([q_b], m.dag.Routing.ISOLATED, None,
                                    None)
    t = m.tasklet.ProcessorTasklet(
        "src", Src(), [], [col_a, col_b],
        m.tasklet.SnapshotContext(m.tasklet.GUARANTEE_NONE), "src", 0,
        is_source=True)
    t.processor.init(t.outbox, None)
    got_a, got_b = [[], []], []
    for _ in range(100_000):
        t.call()
        for qi, q in enumerate(qs_a):
            got_a[qi].extend(q.poll_many(64))
        got_b.extend(q_b.poll_many(64))
        if t.is_done:
            break
    for qi, q in enumerate(qs_a):
        got_a[qi].extend(q.poll_many(64))
    got_b.extend(q_b.poll_many(64))
    assert t.is_done
    return plain([got_a, got_b]), t.items_out


def test_fanout_flush_equals_reference():
    ref, got = both(fanout_flush)
    assert got == ref


def fused_source_fanout(m):
    """tests/test_hot_path_batching.py::test_fused_source_fanout_routes_watermarks
    on a virtual clock: a fused source whose chain tail feeds a keyed
    window and a raw sink."""
    core = m.core
    raw, windows = [], []
    p = core.Pipeline.create()
    keyed = (p.read_from(lambda: core.PacedGeneratorSource(
                 lambda s: (s, s % 4, 1), rate=100_000, max_events=2000))
               .map(lambda v: v)
               .with_key(lambda v: v % 4))
    (keyed.window(core.sliding(100, 50))
          .aggregate(core.counting())
          .write_to(lambda: core.CollectorSink(windows)))
    keyed.write_to(lambda: core.CollectorSink(raw))
    dag = p.to_dag()
    assert any("+" in name for name in dag.vertices)
    cluster = core.JetCluster(n_nodes=1, cooperative_threads=2,
                              clock=core.VirtualClock(auto_step=0.001))
    job = cluster.submit(dag)
    cluster.run_until_complete(job)
    return (sorted((plain(e) for e in raw), key=repr),
            sorted((plain(e) for e in windows), key=repr))


def test_fused_source_fanout_routes_watermarks_as_reference():
    (ref_raw, ref_win), (got_raw, got_win) = both(fused_source_fanout)
    assert len(ref_raw) == 2000 and len(ref_win) > 0
    assert got_raw == ref_raw
    assert got_win == ref_win


# ---------------------------------------------------------------------------
# Partition tables and IMaps (tests/test_state_backend.py, the partition
# invariants of tests/test_property_invariants.py)
# ---------------------------------------------------------------------------

def partition_table(m, n_members, backup, partitions):
    t = m.state.PartitionTable(list(range(n_members)),
                               partition_count=partitions,
                               backup_count=backup)
    before = [list(r) for r in t.assignments]
    counts = [len(t.partitions_of(mem)) for mem in range(n_members)]
    plan = t.change_membership(list(range(n_members + 1)))
    return before, counts, plain(plan), [list(r) for r in t.assignments]


@pytest.mark.parametrize("n_members,backup,partitions", [
    (3, 1, 271), (5, 1, 271), (10, 1, 271), (2, 0, 128), (7, 1, 128),
    (12, 0, 128)])
def test_partition_table_equals_reference(n_members, backup, partitions):
    """Owners and replicas, balance, and the migration plan of one join."""
    ref, got = both(partition_table, n_members, backup, partitions)
    assert got == ref
    before, counts, _plan, _after = got
    assert sum(counts) == partitions
    assert all(len(set(r)) == len(r) == min(backup + 1, n_members)
               for r in before)


def imap_stores(svc):
    return plain({mem: store for mem, store in svc.stores.items()})


def imap_lifecycle(m):
    """Puts with one backup on 3 members, a member's failure, a double
    sequential failure on 4, and an elastic join on 4 (with its garbage
    collection): every get, count and store after each step."""
    IMap, IMapService = m.state.IMap, m.state.IMapService
    trace = []
    svc = IMapService([0, 1, 2], partition_count=32, backup_count=1)
    mp = IMap(svc, "test")
    for i in range(100):
        mp.put(f"k{i}", i)
    trace += [[mp.get(f"k{i}") for i in range(100)], imap_stores(svc)]
    svc = IMapService([0, 1, 2], partition_count=32, backup_count=1)
    mp = IMap(svc, "t")
    for i in range(200):
        mp.put(i, i * i)
    trace += [svc.kill_member(1), svc.promoted_partitions,
              [mp.get(i) for i in range(200)], imap_stores(svc)]
    svc = IMapService([0, 1, 2, 3], partition_count=64, backup_count=1)
    mp = IMap(svc, "t")
    for i in range(300):
        mp.put(i, i)
    trace += [svc.kill_member(0), svc.kill_member(2),
              [mp.get(i) for i in range(300)], imap_stores(svc)]
    svc = IMapService(list(range(4)), partition_count=271, backup_count=1)
    mp = IMap(svc, "t")
    for i in range(500):
        mp.put(i, i)
    trace += [svc.add_member(4), [mp.get(i) for i in range(500)]]
    svc._garbage_collect()
    trace += [imap_stores(svc)]
    return trace


def test_imap_replication_failure_and_migration_equal_reference():
    ref, got = both(imap_lifecycle)
    assert got == ref
    assert got[0] == list(range(100)) and got[2] == [] and got[3] > 0


def snapshot_writer_copy(m):
    """tests/test_state_backend.py::test_snapshot_writer_copies_mutable_state."""
    svc = m.state.IMapService([0], partition_count=16, backup_count=0)
    store = m.state.SnapshotStore(svc)
    writer = store.writer("job-x")
    ring = {20: 33, 40: 29}
    writer.put(1, "combine", ("k", 0), (80, 80, ring), pid=3)
    ring[100] = 25
    store.commit("job-x", 1)
    return store.vertex_entries("job-x", 1, "combine")


def test_snapshot_writer_copies_mutable_state_as_reference():
    ref, got = both(snapshot_writer_copy)
    assert got == ref == [(("k", 0), (80, 80, {20: 33, 40: 29}))]


# ---------------------------------------------------------------------------
# Backpressure (the first half of tests/test_backpressure_and_rules.py)
# ---------------------------------------------------------------------------

def link_credit(m):
    bp = m.backpressure
    clock = m.core.VirtualClock()
    link = bp.NetworkLink(clock, latency_s=0.0, initial_window=4)
    trace = [[link.offer(i) for i in range(4)], link.offer(99)]
    link.pump()
    trace += [link.poll(), link.offer(99)]
    clock.advance(bp.ACK_INTERVAL_S + 0.01)
    link.pump()
    trace += [link.offer(99), link.remaining_capacity()]
    return trace


def test_link_credit_exhaustion_equals_reference():
    ref, got = both(link_credit)
    assert got == ref
    assert got[1] is False and got[-2] is True


def link_adaptive_window(m):
    bp = m.backpressure
    clock = m.core.VirtualClock()
    link = bp.NetworkLink(clock, latency_s=0.0, initial_window=16)
    windows = []
    for _ in range(6):
        for _ in range(min(100, link.remaining_capacity())):
            link.offer("x")
        link.pump()
        while link.poll() is not None:
            pass
        clock.advance(bp.ACK_INTERVAL_S + 0.001)
        link.pump()
        windows.append(link.receive_window)
    return windows, bp.MIN_RECEIVE_WINDOW, bp.WINDOW_FILL_FACTOR


def test_link_adaptive_window_equals_reference():
    ref, got = both(link_adaptive_window)
    assert got == ref
    windows, lo, fill = got
    assert lo <= windows[-1] <= 100 * fill * 2


def link_fifo(m):
    clock = m.core.VirtualClock()
    link = m.backpressure.NetworkLink(clock, latency_s=0.01)
    trace = [[link.offer(i) for i in range(10)]]
    link.pump()
    trace.append(link.poll())
    clock.advance(0.02)
    link.pump()
    trace.append([link.poll() for _ in range(10)])
    return trace


def test_link_fifo_through_latency_equals_reference():
    ref, got = both(link_fifo)
    assert got == ref and got[1] is None and got[2] == list(range(10))


def coalescer_trace(m, seed):
    """The reference test's literal sequence, then a seeded interleaving of
    observes (non-decreasing per queue) and queue-done calls: every value
    the coalescer returns."""
    c = m.watermark.WatermarkCoalescer(3)
    trace = [c.observe(0, 10), c.observe(1, 20), c.observe(2, 15),
             c.observe(0, 30), c.queue_done(2), c.queue_done(1),
             c.queue_done(0)]
    rng = np.random.RandomState(seed)
    n = int(rng.randint(2, 9))
    c = m.watermark.WatermarkCoalescer(n)
    tops, live = [0] * n, list(range(n))
    for _ in range(200):
        if not live:
            break
        qi = live[int(rng.randint(len(live)))]
        if rng.randint(12) == 0:
            live.remove(qi)
            trace.append(("done", qi, c.queue_done(qi)))
        else:
            tops[qi] += int(rng.randint(0, 30))
            trace.append(("wm", qi, c.observe(qi, tops[qi])))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalescer_min_rule_and_done_exclusion_equal_reference(seed):
    ref, got = both(coalescer_trace, seed)
    assert got == ref
    assert got[:7] == [None, None, 10, 15, 20, 30, None]
