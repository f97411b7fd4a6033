"""Recovery through the durable snapshot chain, in the port and in the
JAX package.

tests/test_durable_store.py's engine tier: a corrupted chain head makes
recovery fall back down the chain (by hand, and by a seeded corruption
schedule through the chaos controller), and a coordinator that died
cold-starts through ``recover_job`` with zero loss.  Each runs Q5 with
host placement in both packages, and with ``placement="device"`` (the
port's ``DeviceWindowProcessor`` on ``device="cpu"``) against the JAX
package's device placement.  The runs use a virtual clock, so nothing
here depends on the machine's speed (tests/test_torch_mp_backend.py
holds the ``mp`` cold start).
"""

import importlib

import pytest

pytest.importorskip("torch")

RATE = 60_000
TOTAL = 48_000
DEVICE_TOTAL = 24_000


def _pkg(name):
    return dict(core=importlib.import_module(name + ".core"),
                engine=importlib.import_module(name + ".core.engine"),
                nexmark=importlib.import_module(name + ".nexmark"),
                chaos=importlib.import_module(name + ".runtime.chaos"))


def _dedup(out):
    return sorted(set((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                      for ev in out))


class _Q5:
    """Builds tests/test_durable_store.py's durable exactly-once Q5 in one
    package, with host or device placement."""

    def __init__(self, name, placement="host", backend="inproc",
                 interval=0.1, total=None):
        self.m = _pkg(name)
        self.name, self.placement = name, placement
        self.backend, self.interval = backend, interval
        self.total = total or (TOTAL if placement == "host"
                               else DEVICE_TOTAL)

    def cluster(self, snap_dir=None):
        core = self.m["core"]
        clock = core.VirtualClock(auto_step=0.001) \
            if self.backend == "inproc" else None
        return core.JetCluster(n_nodes=2, cooperative_threads=2,
                               backend=self.backend, clock=clock,
                               snapshot_dir=snap_dir)

    def pipeline(self, out):
        core, nx = self.m["core"], self.m["nexmark"]
        device = None
        if self.placement == "device":
            device = dict(n_key_buckets=64, batch_size=256)
            if self.name == "repro_torch":
                device["device"] = "cpu"
        return nx.queries.q5(
            lambda: core.PacedGeneratorSource(
                nx.NexmarkGenerator(rate=RATE, n_keys=40), rate=RATE,
                max_events=self.total),
            lambda: core.CollectorSink(out), window_ms=100, slide_ms=20,
            placement=self.placement, device=device)

    def submit(self, cluster):
        core, engine = self.m["core"], self.m["engine"]
        out = []
        job = cluster.submit(self.pipeline(out).to_dag(), core.JobConfig(
            processing_guarantee=core.GUARANTEE_EXACTLY_ONCE,
            snapshot_interval_s=self.interval, barrier_timeout_s=5.0,
            restart_policy=engine.RestartPolicy(max_restarts=8)))
        return job, out

    def drive(self, cluster, job, until=None, tick=None,
              max_steps=4_000_000):
        engine = self.m["engine"]
        for _ in range(max_steps):
            if job.status in (engine.JOB_COMPLETED, engine.JOB_FAILED):
                break
            if until is not None and until():
                return
            cluster.step()
            if tick is not None:
                tick()
        assert until is None, "the job ended before until() held"
        assert job.status == engine.JOB_COMPLETED, job.recovery_diagnostics()

    def clean(self, tmp_path):
        cluster = self.cluster(tmp_path / f"clean-{self.name}")
        try:
            job, out = self.submit(cluster)
            self.drive(cluster, job)
            assert job.snapshots_taken >= 1
        finally:
            cluster.shutdown()
        return _dedup(out)


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The unfailed durable run of each placement, equal in both
    packages; device placement's also equal to host placement's on its
    (shorter) stream."""
    cache = {}

    def get(placement):
        if placement not in cache:
            tmp = tmp_path_factory.mktemp(placement)
            port = _Q5("repro_torch", placement).clean(tmp)
            ref = _Q5("repro", placement).clean(tmp)
            assert port == ref and port
            if placement == "device":
                assert port == _Q5("repro_torch", "host",
                                   total=DEVICE_TOTAL).clean(tmp)
            cache[placement] = port
        return cache[placement]

    return get


def _skipped(job):
    return [s for r in job.recovery_log if r["event"] in ("restore",
                                                           "cold_start")
            for s in r["skipped"]]


@pytest.mark.parametrize("name", ["repro_torch", "repro"])
def test_corrupt_head_falls_back_down_the_chain(tmp_path, clean, name):
    """Corrupt the newest committed snapshot, kill a tasklet before
    anything can commit: recovery detects the damage, records the
    skipped id, restores an older entry, and the result set equals the
    unfailed run's — in both packages."""
    q = _Q5(name)
    cluster = q.cluster(tmp_path / "chain")
    try:
        job, out = q.submit(cluster)
        q.drive(cluster, job,
                until=lambda: job.snapshots_taken >= 2 and len(out) >= 50)
        store = cluster.snapshot_store
        chain = store.recovery_chain(job.id)
        assert len(chain) >= 2
        head = chain[0]
        assert q.m["chaos"].corrupt_snapshot(store, job.id, head,
                                             "corrupt_flip")
        assert cluster.backend.inject_fault(job.execution, "kill", 0)
        q.drive(cluster, job)
    finally:
        cluster.shutdown()
    assert _dedup(out) == clean("host")
    assert job.auto_restarts >= 1
    assert any(s["snapshot_id"] == head
               and "verification failed" in s["reason"]
               for s in _skipped(job))
    assert any(r.get("restored_snapshot") is not None
               and r["restored_snapshot"] < head
               for r in job.recovery_log if r["event"] == "restore")


def _seeded_corruption(q, tmp_path, kind, seed=7):
    cluster = q.cluster(tmp_path / f"chain-{q.name}")
    try:
        job, out = q.submit(cluster)
        expected = max(200, (q.total * 1000 // RATE) // 20)
        schedule = q.m["chaos"].ChaosSchedule.corruption_from_seed(
            seed=seed, n_faults=1, total_results=expected, kinds=(kind,))
        ctl = q.m["chaos"].ChaosController(cluster, job, out, schedule)
        q.drive(cluster, job, tick=ctl.tick)
    finally:
        cluster.shutdown()
    fired = [(f.kind, f.at_result, f.fired_at_result,
              f.params.get("snapshot_id")) for f in schedule.faults
             if f.fired]
    return _dedup(out), job, fired


@pytest.mark.parametrize("kind", ["corrupt_flip", "corrupt_truncate",
                                  "corrupt_manifest"])
def test_seeded_corruption_schedule_recovers(tmp_path, clean, kind):
    """A corruption schedule from a seed (the chain head damaged, a kill
    in the same tick) recovers by verified fallback, exactly-once; the
    JAX package's run of the same seed fires the same faults at the same
    result counts against the same snapshot and ends equal."""
    got, job, fired = _seeded_corruption(_Q5("repro_torch"), tmp_path, kind)
    ref, _, ref_fired = _seeded_corruption(_Q5("repro"), tmp_path, kind)
    assert {f[0] for f in fired} == {kind, "kill"}
    assert fired == ref_fired
    assert got == ref == clean("host")
    victim = next(f[3] for f in fired if f[0] == kind)
    assert any(s["snapshot_id"] == victim for s in _skipped(job))


def _interrupt_then_recover(q, tmp_path, until_results=50, tick=None):
    """Run a durable Q5, let the coordinator die mid-run (shutdown with
    the job RUNNING), cold-start a fresh cluster on the same chain with
    ``recover_job``; returns both halves' results and the new job."""
    snap_dir = tmp_path / f"cold-{q.name}-{q.placement}"
    cluster1 = q.cluster(snap_dir)
    try:
        job1, out1 = q.submit(cluster1)
        q.drive(cluster1, job1, until=lambda: job1.snapshots_taken >= 1
                and len(out1) >= until_results)
        if tick is not None:
            tick(cluster1, job1)
    finally:
        cluster1.shutdown()
    cluster2 = q.cluster(snap_dir)
    try:
        out2 = []
        job2 = cluster2.recover_job(q.pipeline(out2).to_dag())
        assert job2.id == job1.id
        cold = job2.recovery_log[0]
        assert cold["event"] == "cold_start"
        assert cold["restored_snapshot"] is not None
        if q.name == "repro_torch":
            # ROADMAP.md §3, F3: the rebuilt pipeline's vertices carry the
            # names the chain was written under, so the restore restores
            assert cold["entries"] > 0
        core = q.m["core"]
        assert job2.config.processing_guarantee == \
            core.GUARANTEE_EXACTLY_ONCE
        assert job2.config.snapshot_interval_s == pytest.approx(q.interval)
        q.drive(cluster2, job2)
    finally:
        cluster2.shutdown()
    return sorted(set(_dedup(out1)) | set(_dedup(out2))), job2


@pytest.mark.parametrize("placement", ["host", "device"])
def test_cold_start_recover_job_inproc(tmp_path, clean, placement):
    """Zero loss across the two halves, in the port and in the JAX
    package; device placement restores the window state from the chain
    onto the port's executor device."""
    got, job = _interrupt_then_recover(_Q5("repro_torch", placement),
                                       tmp_path)
    assert got == clean(placement)
    if placement == "device":
        from repro_torch.core import DeviceWindowProcessor
        procs = [t.processor for t in job.execution.tasklets
                 if isinstance(t.processor, DeviceWindowProcessor)]
        assert procs and all(p.executor.device.type == "cpu"
                             for p in procs)
    ref, _ = _interrupt_then_recover(_Q5("repro", placement), tmp_path)
    assert ref == got


def test_cold_start_through_a_corrupted_head_device(tmp_path, clean):
    """Device placement: the chain head is corrupted just before the
    coordinator dies, so the cold start must skip it and restore an
    older entry; the two halves still hold every result once."""
    q = _Q5("repro_torch", "device")
    victim = []

    def corrupt_head(cluster, job):
        q.drive(cluster, job, until=lambda: job.snapshots_taken >= 2)
        store = cluster.snapshot_store
        head = store.recovery_chain(job.id)[0]
        assert q.m["chaos"].corrupt_snapshot(store, job.id, head,
                                             "corrupt_flip")
        victim.append(head)

    got, job = _interrupt_then_recover(q, tmp_path, tick=corrupt_head)
    assert got == clean("device")
    cold = job.recovery_log[0]
    assert cold["restored_snapshot"] < victim[0]
    assert any(s["snapshot_id"] == victim[0] for s in cold["skipped"])


def test_seeded_corruption_schedule_recovers_device(tmp_path, clean):
    """The seeded corruption schedule with the port's device window on
    the CPU: equal to the JAX package's device placement, unfailed."""
    got, job, fired = _seeded_corruption(_Q5("repro_torch", "device"),
                                         tmp_path, "corrupt_flip", seed=3)
    assert {f[0] for f in fired} == {"corrupt_flip", "kill"}
    assert got == clean("device")
    assert job.auto_restarts >= 1


def test_recover_job_without_chain_raises(tmp_path):
    q = _Q5("repro_torch")
    cluster = q.cluster(tmp_path / "empty")
    try:
        with pytest.raises(ValueError, match="recover_job"):
            cluster.recover_job(q.pipeline([]).to_dag())
    finally:
        cluster.shutdown()


@pytest.mark.parametrize("kill_at", [40, 212, 340, 500])
def test_device_kill_at_any_point_equals_clean(tmp_path, clean, kill_at):
    """ROADMAP.md §3, F2: device placement on two nodes, one tasklet
    killed once the sink holds ``kill_at`` results; the restore, from an
    early or a late snapshot, reproduces the unfailed run (equal to the
    JAX package's device placement and to host placement)."""
    q = _Q5("repro_torch", "device")
    cluster = q.cluster(tmp_path / "chain")
    try:
        job, out = q.submit(cluster)
        q.drive(cluster, job, until=lambda: job.snapshots_taken >= 1
                and len(out) >= kill_at)
        assert cluster.backend.inject_fault(job.execution, "kill", 0)
        q.drive(cluster, job)
    finally:
        cluster.shutdown()
    assert job.auto_restarts >= 1
    assert _dedup(out) == clean("device")


def test_cold_start_restores_the_chain_and_delivers_once(tmp_path, clean):
    """ROADMAP.md §3, F3: a cold start in the process that wrote the chain
    restores its entries (the reference's rebuilt pipeline gets new vertex
    names and restores none, replaying the stream from its start), so a
    transactional sink whose external system outlives the coordinator
    receives every result exactly once across the two halves."""
    from repro_torch.snapshot import ExternalCollector, TransactionalSink
    q = _Q5("repro_torch", "device")
    core, nx = q.m["core"], q.m["nexmark"]
    collector = ExternalCollector()

    def pipeline():
        return nx.queries.q5(
            lambda: core.PacedGeneratorSource(
                nx.NexmarkGenerator(rate=RATE, n_keys=40), rate=RATE,
                max_events=q.total),
            lambda: TransactionalSink(collector), window_ms=100,
            slide_ms=20, placement="device",
            device=dict(n_key_buckets=64, batch_size=256, device="cpu"))

    snap_dir = tmp_path / "chain"
    cluster = q.cluster(snap_dir)
    try:
        job = cluster.submit(pipeline().to_dag(), core.JobConfig(
            processing_guarantee=core.GUARANTEE_EXACTLY_ONCE,
            snapshot_interval_s=0.02))
        first_names = sorted(job.dag.vertices)
        q.drive(cluster, job, until=lambda: job.snapshots_taken >= 2
                and len(collector.committed) >= 150)
    finally:
        cluster.shutdown()
    cluster = q.cluster(snap_dir)
    try:
        job2 = cluster.recover_job(pipeline().to_dag())
        assert sorted(job2.dag.vertices) == first_names
        cold = job2.recovery_log[0]
        assert cold["entries"] > 0
        q.drive(cluster, job2)
    finally:
        cluster.shutdown()
    keys = [(wr.window_end, wr.key) for _txn, wr in collector.committed]
    assert len(keys) == len(set(keys))
    got = sorted((wr.window_end - 1, wr.key, wr.window_end, wr.value)
                 for _txn, wr in collector.committed)
    assert got == clean("device")
