"""The port's exactly-once delivery endpoints (``snapshot/``) against the
JAX package's.

tests/test_sinks_and_ft_extras.py's pipelines, in both packages on the
same journal and the same virtual clock: an idempotent sink and a
transactional sink through a node kill, and active-active replicas
through the loss of the primary.  What reaches the external system must
equal the window oracle and the JAX package's delivery, each result
exactly once.
"""

import importlib

import pytest

pytest.importorskip("torch")

EVENTS = [(i, i % 5, i) for i in range(400)]


def window_count_oracle(events, size, slide):
    expect = {}
    for ts, key, _ in events:
        fw = (ts // slide + 1) * slide
        for w in range(fw, fw + size, slide):
            expect[(w, key)] = expect.get((w, key), 0) + 1
    return expect


def _mods(name):
    return (importlib.import_module(name + ".core"),
            importlib.import_module(name + ".snapshot"),
            importlib.import_module(name + ".core.engine"))


def build_job(core, out_sink_supplier, rate=150.0):
    journal = core.Journal(n_partitions=8)
    journal.extend((ts, key, (key, p)) for ts, key, p in EVENTS)
    p = core.Pipeline.create()
    (p.read_from(lambda: core.JournalSource(journal, rate=rate), name="src")
       .with_key(lambda v: v[0])
       .window(core.sliding(40, 10))
       .aggregate(core.counting())
       .write_to(out_sink_supplier))
    return p


def _run_with_kill(name, make_sink, kill):
    core, snap, _ = _mods(name)
    collector = snap.ExternalCollector()
    p = build_job(core, lambda: make_sink(snap, collector))
    cluster = core.JetCluster(n_nodes=3, cooperative_threads=2,
                              clock=core.VirtualClock(auto_step=0.01))
    job = cluster.submit(p.to_dag(), core.JobConfig(
        processing_guarantee=core.GUARANTEE_EXACTLY_ONCE,
        snapshot_interval_s=0.05))
    for _ in range(20000):
        cluster.step()
        if job.snapshots_taken >= 1:
            break
    assert job.snapshots_taken >= 1
    cluster.kill_node(kill)
    cluster.run_until_complete(job)
    return collector, job


@pytest.mark.parametrize("kill", [1, 2])
def test_idempotent_sink_no_duplicates_after_failure(kill):
    def make(snap, collector):
        return snap.IdempotentSink(
            collector,
            key_fn=lambda ev: (ev.value.window_end, ev.value.key))

    port, job = _run_with_kill("repro_torch", make, kill)
    ref, _ = _run_with_kill("repro", make, kill)
    assert job.restarts >= 1
    got = {k: v.value for k, v in port.kv.items()}
    assert got == window_count_oracle(EVENTS, 40, 10)
    assert got == {k: v.value for k, v in ref.kv.items()}


@pytest.mark.parametrize("kill", [1, 2])
def test_transactional_sink_exactly_once_delivery(kill):
    """Every committed result is exact, no (window, key) commits twice,
    and the epochs the external system saw are the JAX package's."""
    def make(snap, collector):
        return snap.TransactionalSink(collector)

    def delivered(collector):
        seen = {}
        for _epoch, wr in collector.committed:
            k = (wr.window_end, wr.key)
            assert k not in seen, f"double delivery of {k}"
            seen[k] = wr.value
        return seen

    port, job = _run_with_kill("repro_torch", make, kill)
    ref, _ = _run_with_kill("repro", make, kill)
    assert job.restarts >= 1
    seen = delivered(port)
    assert seen == window_count_oracle(EVENTS, 40, 10)
    assert seen == delivered(ref)
    assert sorted(map(repr, port._epochs_seen)) == \
        sorted(map(repr, ref._epochs_seen))


def test_transactional_sink_fences_a_recommit():
    from repro_torch.snapshot import ExternalCollector
    c = ExternalCollector()
    c.commit_epoch((1, 0), ["a", "b"])
    c.commit_epoch((1, 0), ["a", "b"])
    c.commit_epoch((2, 0), ["c"])
    assert c.committed == [((1, 0), "a"), ((1, 0), "b"), ((2, 0), "c")]


def _active_active(name, kill_at=20):
    core, snap, engine = _mods(name)
    proc = importlib.import_module(name + ".core.processor")

    def build(sink_consumer):
        return build_job(core, lambda: proc.SinkProcessor(sink_consumer),
                         rate=300.0)

    runner = snap.ActiveActiveRunner(
        build, id_fn=lambda ev: (ev.value.window_end, ev.value.key),
        n_nodes=2, clock_factory=lambda: core.VirtualClock(auto_step=0.01))
    for _ in range(200000):
        runner.step()
        if (len(runner.output.results) > kill_at
                and runner.jobs[0].status != engine.JOB_COMPLETED):
            break
    assert runner.jobs[0].status != engine.JOB_COMPLETED
    runner.kill_replica(0)
    runner.run_until_complete()
    return runner


@pytest.mark.parametrize("kill_at", [20, 120])
def test_active_active_survives_replica_loss(kill_at):
    port = _active_active("repro_torch", kill_at)
    ref = _active_active("repro", kill_at)
    got = {k: ev.value.value for k, (_, ev) in port.output.results.items()}
    assert got == window_count_oracle(EVENTS, 40, 10)
    assert got == {k: ev.value.value
                   for k, (_, ev) in ref.output.results.items()}
    # the standby contributed after the primary died, as in the reference
    rep = {k: r for k, (r, _) in port.output.results.items()}
    assert any(r == 1 for r in rep.values())
    assert rep == {k: r for k, (r, _) in ref.output.results.items()}
    assert port.output.duplicates == ref.output.duplicates
