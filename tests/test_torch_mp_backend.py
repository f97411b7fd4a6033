"""The port's multiprocess backend (``runtime/worker_proc.py`` over
``core/shm_ring.py``) against its in-process backend and the JAX
package's.

tests/test_mp_backend.py's pipelines: blocked NEXMark Q5 across real
worker processes over shared-memory rings, ordered and disordered, the
late-drop tally, the scalar path, and exactly-once through ``kill_node``.
Each ``mp`` run is compared with the clean in-process run of the same
stream, which runs on a virtual clock, and with the JAX package's
in-process run of it: the result sets and the late-drop counts must be
equal; nothing is compared with a wall-clock speed.  The JAX package's
own ``mp`` backend is not run here: its rings carry the prefix its
tests sweep and count.
"""

import importlib
import os
import time

import pytest

pytest.importorskip("torch")

RATE = 60_000
TOTAL = 24_000
#: a bound on every run's wall time: a stuck job fails, it never hangs
DEADLINE_S = 120.0


def _pkg(name):
    return dict(core=importlib.import_module(name + ".core"),
                engine=importlib.import_module(name + ".core.engine"),
                nexmark=importlib.import_module(name + ".nexmark"))


def _run_q5(name, backend, block_size=None, disorder=0, wm_lag=None,
            n_nodes=1, threads=2, exactly_once=False, kill_at_result=None,
            total=TOTAL, placement="host", info=None):
    """test_mp_backend.py's ``_run_q5`` for either package: the sorted set
    of ``(ts, key, window_end, value)`` and the late drops.  ``inproc``
    runs on a virtual clock; ``mp`` on the wall clock (worker processes
    cannot observe a virtual one), paced at ``RATE``."""
    m = _pkg(name)
    core, nx = m["core"], m["nexmark"]
    gen = nx.NexmarkGenerator(rate=RATE, n_keys=40)
    if disorder:
        gen = nx.DisorderedNexmarkGenerator(gen, max_skew_ms=disorder, seed=9)
        total = (total // gen.block) * gen.block
    clock = core.VirtualClock(auto_step=0.001) if backend == "inproc" \
        else None
    cluster = core.JetCluster(n_nodes=n_nodes, cooperative_threads=threads,
                              backend=backend, clock=clock)
    out = []
    device = dict(device="cpu", n_key_buckets=64, batch_size=256) \
        if placement == "device" else None
    p = nx.queries.q5(
        lambda: core.PacedGeneratorSource(
            gen, rate=RATE, max_events=total,
            wm_lag=disorder if wm_lag is None else wm_lag,
            block_size=block_size),
        lambda: core.CollectorSink(out), window_ms=100, slide_ms=20,
        placement=placement, device=device)
    guarantee = core.GUARANTEE_EXACTLY_ONCE if exactly_once \
        else core.GUARANTEE_NONE
    job = None
    try:
        job = cluster.submit(p.to_dag(), core.JobConfig(
            processing_guarantee=guarantee, snapshot_interval_s=0.1))
        killed = False
        deadline = time.monotonic() + DEADLINE_S
        while job.status not in (m["engine"].JOB_COMPLETED,
                                 m["engine"].JOB_FAILED):
            assert time.monotonic() < deadline, job.recovery_diagnostics()
            cluster.step()
            if (kill_at_result is not None and not killed
                    and len(out) >= kill_at_result
                    and job.snapshots_taken > 0):
                cluster.kill_node(cluster.node_ids[-1])
                killed = True
        assert job.status == m["engine"].JOB_COMPLETED
        if kill_at_result is not None:
            assert killed, "node was never killed — test setup broken"
        drops = sum(getattr(t.processor, "late_dropped", 0)
                    for t in job.execution.tasklets)
        if info is not None:
            data = job.execution.backend_data
            info["workers"] = {k: h.proc.pid
                               for k, h in data.get("workers", {}).items()}
            info["rings"] = [r.name for r in data.get("rings", ())]
            info["restarts"] = job.restarts
    finally:
        cluster.shutdown()
    return (sorted(set((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                       for ev in out)), drops)


@pytest.fixture(scope="module")
def clean_inproc():
    """The port's and the JAX package's in-process runs of each stream,
    keyed by the stream's options."""
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            port = _run_q5("repro_torch", "inproc", **kw)
            assert port == _run_q5("repro", "inproc", **kw)
            cache[key] = port
        return cache[key]

    return get


def test_make_backend_mp_returns_the_ports_backend():
    from repro_torch.core import JetCluster, make_backend
    from repro_torch.runtime.worker_proc import MultiprocessBackend
    backend = make_backend("mp")
    assert isinstance(backend, MultiprocessBackend)
    assert type(backend).__module__ == "repro_torch.runtime.worker_proc"
    cluster = JetCluster(backend="mp")
    assert isinstance(cluster.backend, MultiprocessBackend)
    assert cluster.backend.name == "mp"
    cluster.shutdown()


def test_mp_runs_q5_across_worker_processes(clean_inproc):
    """Blocked Q5 on two real worker processes equals the in-process run
    of both packages."""
    info = {}
    got = _run_q5("repro_torch", "mp", info=info)
    assert sorted(info["workers"]) == [(0, 0), (0, 1)]
    assert os.getpid() not in info["workers"].values()
    assert len(set(info["workers"].values())) == 2
    assert got == clean_inproc() and len(got[0]) > 0


@pytest.mark.parametrize("disorder", [0, 40])
def test_mp_equals_inproc(clean_inproc, disorder):
    """Ordered, and disordered by up to 40 ms behind a covering watermark
    lag: the same result set and the same late drops as in process."""
    got = _run_q5("repro_torch", "mp", disorder=disorder)
    ref = clean_inproc(disorder=disorder)
    assert got[0] == ref[0] and len(ref[0]) > 0
    assert got[1] == ref[1]


def test_mp_equals_inproc_late_drop_counts(clean_inproc):
    """A watermark lag below the skew drops late events; on one worker the
    tally is deterministic, so ``mp`` reports the in-process count (and
    the JAX package's) through the cross-process stats mirror."""
    kw = dict(disorder=40, wm_lag=0, threads=1)
    got = _run_q5("repro_torch", "mp", **kw)
    ref = clean_inproc(**kw)
    assert ref[1] > 0
    assert got == ref


def test_mp_scalar_path_equals_blocked(clean_inproc):
    scalar = _run_q5("repro_torch", "mp", block_size=0)
    blocked = _run_q5("repro_torch", "mp", block_size=None)
    assert scalar == blocked == clean_inproc()


def test_mp_exactly_once_through_kill_node(clean_inproc):
    """A node failure mid-run tears every worker down, restores in the
    coordinator and re-forks: the result set equals the unkilled run's."""
    info = {}
    killed = _run_q5("repro_torch", "mp", n_nodes=2, exactly_once=True,
                     kill_at_result=200, info=info)
    assert info["restarts"] >= 1
    base = clean_inproc(n_nodes=2)
    assert killed[0] == base[0] and len(base[0]) > 0
    assert killed[1] == base[1]


def test_mp_restore_equals_inproc_restore(clean_inproc):
    """The equivalence holds after snapshot and restore on both
    substrates, and against the JAX package's in-process restore."""
    kw = dict(n_nodes=2, exactly_once=True, kill_at_result=200)
    port_inproc = _run_q5("repro_torch", "inproc", **kw)
    assert port_inproc == _run_q5("repro", "inproc", **kw)
    got = _run_q5("repro_torch", "mp", **kw)
    assert got[0] == port_inproc[0] and len(got[0]) > 0


def test_mp_rejects_virtual_clock():
    from repro_torch.core import JetCluster, VirtualClock
    with pytest.raises(ValueError, match="does not support"):
        JetCluster(clock=VirtualClock(auto_step=0.001), backend="mp")


def test_unknown_backend_rejected():
    from repro_torch.core import JetCluster
    with pytest.raises(ValueError, match="unknown execution backend"):
        JetCluster(backend="threads")


def test_device_placement_on_mp_raises():
    """As in the reference: a job with a device-offloaded vertex is
    refused before any worker process starts."""
    from repro_torch.core import (CollectorSink, JetCluster, JobConfig,
                                  PacedGeneratorSource)
    from repro_torch.nexmark import NexmarkGenerator, queries
    cluster = JetCluster(n_nodes=1, cooperative_threads=2, backend="mp")
    try:
        p = queries.q5(
            lambda: PacedGeneratorSource(NexmarkGenerator(rate=RATE),
                                         rate=RATE, max_events=1000),
            lambda: CollectorSink([]), window_ms=100, slide_ms=20,
            placement="device",
            device=dict(device="cpu", n_key_buckets=64, batch_size=256))
        with pytest.raises(NotImplementedError, match="inproc"):
            cluster.submit(p.to_dag(), JobConfig())
        assert not cluster.jobs
    finally:
        cluster.shutdown()


def test_mp_teardown_unlinks_the_rings_it_created():
    """Every ring of the job's execution is gone from /dev/shm once the
    job completed (only this job's ring names are checked)."""
    from repro_torch.core.shm_ring import RING_NAME_PREFIX
    info = {}
    _run_q5("repro_torch", "mp", n_nodes=2, info=info)
    assert info["rings"], "the job planned no cross-process edge"
    assert all(n.startswith(RING_NAME_PREFIX) for n in info["rings"])
    left = set(os.listdir("/dev/shm")) & set(info["rings"])
    assert not left


def test_cold_start_recover_job_mp(tmp_path):
    """tests/test_durable_store.py's ``mp`` cold start: a durable run whose
    coordinator dies after a commit, then a fresh ``mp`` cluster that
    cold-starts from the chain with ``recover_job``; the union of the two
    halves equals the clean in-process run of the same durable job."""
    from repro_torch.core import (CollectorSink, GUARANTEE_EXACTLY_ONCE,
                                  JetCluster, JobConfig, PacedGeneratorSource,
                                  VirtualClock)
    from repro_torch.core.engine import (JOB_COMPLETED, JOB_FAILED,
                                         RestartPolicy)
    from repro_torch.nexmark import NexmarkGenerator, queries

    def pipeline(out):
        return queries.q5(
            lambda: PacedGeneratorSource(
                NexmarkGenerator(rate=RATE, n_keys=40), rate=RATE,
                max_events=2 * TOTAL),
            lambda: CollectorSink(out), window_ms=100, slide_ms=20)

    def submit(cluster, out):
        return cluster.submit(pipeline(out).to_dag(), JobConfig(
            processing_guarantee=GUARANTEE_EXACTLY_ONCE,
            snapshot_interval_s=0.2, barrier_timeout_s=5.0,
            restart_policy=RestartPolicy(max_restarts=8)))

    def drive(cluster, job, until=None):
        deadline = time.monotonic() + DEADLINE_S
        while job.status not in (JOB_COMPLETED, JOB_FAILED):
            if until is not None and until():
                return
            assert time.monotonic() < deadline, job.recovery_diagnostics()
            cluster.step()
        assert until is None and job.status == JOB_COMPLETED

    def dedup(out):
        return set((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                   for ev in out)

    clean = []
    cluster = JetCluster(n_nodes=2, cooperative_threads=2,
                         clock=VirtualClock(auto_step=0.001),
                         snapshot_dir=tmp_path / "clean")
    try:
        drive(cluster, submit(cluster, clean))
    finally:
        cluster.shutdown()

    snap_dir = tmp_path / "chain"
    cluster1 = JetCluster(n_nodes=2, cooperative_threads=2, backend="mp",
                          snapshot_dir=snap_dir)
    out1 = []
    try:
        job1 = submit(cluster1, out1)
        drive(cluster1, job1,
              until=lambda: job1.snapshots_taken >= 1 and len(out1) >= 50)
    finally:
        # coordinator death, no graceful job stop; the workers' stop ships
        # the results they hold, so nothing emitted before it is lost
        cluster1.shutdown()
    cluster2 = JetCluster(n_nodes=2, cooperative_threads=2, backend="mp",
                          snapshot_dir=snap_dir)
    out2 = []
    try:
        job2 = cluster2.recover_job(pipeline(out2).to_dag())
        assert job2.id == job1.id
        cold = job2.recovery_log[0]
        assert cold["event"] == "cold_start" and cold["entries"] > 0
        drive(cluster2, job2)
    finally:
        cluster2.shutdown()
    assert dedup(out1) | dedup(out2) == dedup(clean) and clean
