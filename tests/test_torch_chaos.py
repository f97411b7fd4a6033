"""The port's chaos layer (``runtime/chaos.py``) against the JAX
package's.

The same seed must give the same schedule in both packages, field by
field, and the controller must fire at the same logical triggers, skip
the same kinds and gate the same way.  Then tests/test_chaos.py's seeded
kill equivalence, in process: exactly-once Q5 on two nodes with one
seeded kill equals the clean run, in the port and in the JAX package
alike.  The in-process runs use a virtual clock, so nothing here depends
on the machine's speed.
"""

import importlib

import pytest

pytest.importorskip("torch")

from repro.runtime import chaos as ref_chaos  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402

RATE = 60_000
TOTAL = 48_000
SEEDS = (1, 2, 3)


def _plan(schedule):
    return [(f.kind, f.at_result, f.worker_index, dict(f.params))
            for f in schedule.faults]


# ---------------------------------------------------------------- schedule --

def test_kind_constants_equal_the_reference():
    assert chaos.ALL_KINDS == ref_chaos.ALL_KINDS
    assert chaos.CORRUPTION_KINDS == ref_chaos.CORRUPTION_KINDS
    assert (chaos.KIND_KILL, chaos.KIND_STALL, chaos.KIND_RAISE,
            chaos.KIND_DROP_ACK, chaos.KIND_DELAY_ACK) == \
        (ref_chaos.KIND_KILL, ref_chaos.KIND_STALL, ref_chaos.KIND_RAISE,
         ref_chaos.KIND_DROP_ACK, ref_chaos.KIND_DELAY_ACK)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2024, 99991])
@pytest.mark.parametrize("kw", [
    pytest.param(dict(n_faults=5, total_results=1000), id="all_kinds"),
    pytest.param(dict(n_faults=1, total_results=1000, kinds=("kill",),
                      lo_frac=0.05, hi_frac=0.3), id="one_kill"),
    pytest.param(dict(n_faults=12, total_results=50_000,
                      stall_duration_s=0.2, ack_delay_s=0.7),
                 id="many_params"),
    pytest.param(dict(n_faults=8, total_results=5,
                      kinds=("raise", "drop_ack")), id="tiny_interval"),
])
def test_from_seed_equals_the_reference(seed, kw):
    port = chaos.ChaosSchedule.from_seed(seed, **kw)
    ref = ref_chaos.ChaosSchedule.from_seed(seed, **kw)
    assert _plan(port) == _plan(ref) and port.faults
    assert port.seed == ref.seed == seed


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
@pytest.mark.parametrize("n_faults", [1, 3])
def test_corruption_from_seed_equals_the_reference(seed, n_faults):
    port = chaos.ChaosSchedule.corruption_from_seed(
        seed, n_faults=n_faults, total_results=2000)
    ref = ref_chaos.ChaosSchedule.corruption_from_seed(
        seed, n_faults=n_faults, total_results=2000)
    assert _plan(port) == _plan(ref)
    kinds = [f.kind for f in port.faults]
    assert kinds.count("kill") == n_faults
    # each corruption is chased by a kill at the same logical point
    for i in range(0, len(port.faults), 2):
        a, b = port.faults[i], port.faults[i + 1]
        assert a.kind in chaos.CORRUPTION_KINDS and b.kind == "kill"
        assert a.at_result == b.at_result


def test_schedule_covers_every_kind():
    s = chaos.ChaosSchedule.from_seed(7, n_faults=len(chaos.ALL_KINDS),
                                      total_results=5000)
    assert {f.kind for f in s.faults} == set(chaos.ALL_KINDS)
    ats = [f.at_result for f in s.faults]
    assert ats == sorted(ats) and all(1 <= at <= 3500 for at in ats)


# -------------------------------------------------------------- controller --

class _SpyBackend:
    def __init__(self, supported=True, veto=()):
        self.supported = supported
        self.veto = set(veto)
        self.calls = []

    def inject_fault(self, execution, kind, worker_index=0, **params):
        self.calls.append((kind, worker_index, params))
        return self.supported and kind not in self.veto


class _FakeJob:
    def __init__(self, status):
        self.id = "job"
        self.status = status
        self.execution = type("E", (), {"ssctx": None})()
        self.snapshots_taken = 0


def _drive_controller(mod, schedule_of, script, veto=()):
    """Drive a controller of ``mod`` through ``script``: a list of
    (results in the sink, snapshots taken, barrier requested id, job
    running) states, one tick each.  Returns what each tick returned, the
    spy's calls and the controller's log."""
    engine = importlib.import_module(
        mod.__name__.replace("runtime.chaos", "core.engine"))
    backend = _SpyBackend(veto=veto)
    cluster = type("C", (), {"backend": backend, "snapshot_store": None})()
    job = _FakeJob(engine.JOB_RUNNING)
    sink = []
    ctl = mod.ChaosController(cluster, job, sink, schedule_of(mod))
    ticks = []
    for n, snaps, requested, running in script:
        sink.extend(range(n - len(sink)))
        job.snapshots_taken = snaps
        job.execution.ssctx = type("S", (), {"requested_id": requested})()
        job.status = engine.JOB_RUNNING if running else engine.JOB_COMPLETED
        ticks.append(ctl.tick())
    log = [(f.kind, f.at_result, f.fired, f.skipped, f.fired_at_result)
           for f in ctl.log]
    return ticks, backend.calls, log


_SCRIPT = [(0, 0, 0, True), (5, 0, 0, True), (5, 0, 1, True),
           (6, 1, 1, False), (6, 1, 1, True), (40, 1, 2, True),
           (40, 2, 2, True), (90, 2, 3, True), (200, 3, 3, True),
           (400, 4, 4, True), (400, 4, 4, True), (2000, 5, 5, True)]


@pytest.mark.parametrize("seed", SEEDS + (17,))
@pytest.mark.parametrize("veto", [(), ("stall", "drop_ack", "delay_ack")],
                         ids=["all_supported", "inproc_veto"])
def test_controller_fires_as_the_reference(seed, veto):
    """A seeded schedule of every kind through both controllers over the
    same scripted run: the same ticks fire, the same faults reach the
    backend with the same targets, the same kinds are skipped."""
    def schedule_of(mod):
        return mod.ChaosSchedule.from_seed(seed, n_faults=6,
                                           total_results=600)

    port = _drive_controller(chaos, schedule_of, _SCRIPT, veto)
    ref = _drive_controller(ref_chaos, schedule_of, _SCRIPT, veto)
    assert port == ref
    assert any(port[0]), "no fault fired in the scripted run"
    if veto:
        assert any(skipped for _k, _a, _f, skipped, _r in port[2])


def test_controller_fires_at_logical_trigger():
    from repro_torch.core.engine import JOB_COMPLETED, JOB_RUNNING
    backend = _SpyBackend()
    cluster = type("C", (), {"backend": backend})()
    job = _FakeJob(JOB_RUNNING)
    job.snapshots_taken = 1
    sink = []
    ctl = chaos.ChaosController(
        cluster, job, sink,
        chaos.ChaosSchedule([chaos.Fault(chaos.KIND_KILL, at_result=5)]))
    assert not ctl.tick()                   # the sink below the trigger
    sink.extend(range(5))
    job.snapshots_taken = 0
    assert not ctl.tick()                   # no committed snapshot yet
    job.snapshots_taken = 1
    job.status = JOB_COMPLETED
    assert not ctl.tick()                   # only while RUNNING
    job.status = JOB_RUNNING
    assert ctl.tick()
    f = ctl.schedule.faults[0]
    assert f.fired and f.fired_at_result == 5 and f.fired_at is not None
    assert backend.calls == [(chaos.KIND_KILL, f.worker_index, {})]
    assert ctl.schedule.done and not ctl.tick()


def test_controller_ack_fault_fires_on_inflight_barrier():
    from repro_torch.core.engine import JOB_RUNNING
    backend = _SpyBackend()
    cluster = type("C", (), {"backend": backend})()
    job = _FakeJob(JOB_RUNNING)
    sink = list(range(10))
    ctl = chaos.ChaosController(
        cluster, job, sink,
        chaos.ChaosSchedule([chaos.Fault(chaos.KIND_DROP_ACK,
                                         at_result=1)]))
    assert not ctl.tick()                   # no barrier requested yet
    job.execution.ssctx = type("S", (), {"requested_id": 1})()
    assert ctl.tick() and ctl.schedule.faults[0].fired


def test_controller_records_unsupported_kind_as_skipped():
    from repro_torch.core.engine import JOB_RUNNING
    backend = _SpyBackend(supported=False)
    cluster = type("C", (), {"backend": backend})()
    job = _FakeJob(JOB_RUNNING)
    job.snapshots_taken = 1
    ctl = chaos.ChaosController(
        cluster, job, list(range(10)),
        chaos.ChaosSchedule([chaos.Fault("stall", at_result=1)]))
    assert not ctl.tick()
    f = ctl.schedule.faults[0]
    assert f.skipped and not f.fired and ctl.schedule.done


def test_corruption_fault_without_durable_store_is_skipped():
    from repro_torch.core.engine import JOB_RUNNING
    backend = _SpyBackend()
    cluster = type("C", (), {"backend": backend, "snapshot_store": None})()
    job = _FakeJob(JOB_RUNNING)
    ctl = chaos.ChaosController(
        cluster, job, list(range(10)),
        chaos.ChaosSchedule([chaos.Fault(chaos.KIND_CORRUPT_FLIP, 1)]))
    assert not ctl.tick()
    assert ctl.schedule.faults[0].skipped and backend.calls == []


# ------------------------------------------------------- chaos equivalence --

def _chaos_q5(name, seed=None):
    """tests/test_chaos.py's ``_chaos_q5`` in process, on a virtual clock:
    exactly-once Q5 on two nodes; with a seed, one seeded kill through
    the controller.  Returns the deduplicated results, the late drops,
    the fired faults and the automatic restarts."""
    core = importlib.import_module(name + ".core")
    engine = importlib.import_module(name + ".core.engine")
    nx = importlib.import_module(name + ".nexmark")
    mod = importlib.import_module(name + ".runtime.chaos")
    cluster = core.JetCluster(n_nodes=2, cooperative_threads=2,
                              clock=core.VirtualClock(auto_step=0.001))
    out = []
    p = nx.queries.q5(
        lambda: core.PacedGeneratorSource(
            nx.NexmarkGenerator(rate=RATE, n_keys=40), rate=RATE,
            max_events=TOTAL),
        lambda: core.CollectorSink(out), window_ms=100, slide_ms=20)
    job = cluster.submit(p.to_dag(), core.JobConfig(
        processing_guarantee=core.GUARANTEE_EXACTLY_ONCE,
        snapshot_interval_s=0.1))
    ctl = None
    if seed is not None:
        schedule = mod.ChaosSchedule.from_seed(
            seed, n_faults=1, total_results=1000, kinds=(mod.KIND_KILL,),
            lo_frac=0.05, hi_frac=0.3)
        ctl = mod.ChaosController(cluster, job, out, schedule)
    try:
        for _ in range(4_000_000):
            if job.status in (engine.JOB_COMPLETED, engine.JOB_FAILED):
                break
            cluster.step()
            if ctl is not None:
                ctl.tick()
        assert job.status == engine.JOB_COMPLETED
        drops = sum(getattr(t.processor, "late_dropped", 0)
                    for t in job.execution.tasklets)
    finally:
        cluster.shutdown()
    fired = [] if ctl is None else [
        (f.kind, f.at_result, f.worker_index, f.fired_at_result)
        for f in ctl.schedule.fired()]
    results = sorted(set((ev.ts, ev.key, ev.value.window_end,
                          ev.value.value) for ev in out))
    return results, drops, fired, job.auto_restarts


@pytest.fixture(scope="module")
def clean():
    port = _chaos_q5("repro_torch")
    ref = _chaos_q5("repro")
    assert port[:2] == ref[:2] and port[0]
    return port


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_kill_equivalence_inproc(clean, seed):
    """One seeded mid-run kill (an exception planted in a seeded live
    tasklet): the job heals from its last snapshot and the result set
    and late drops equal the clean run's; the JAX package's run of the
    same seed fires the same fault at the same result count and ends
    equal."""
    results, drops, fired, restarts = _chaos_q5("repro_torch", seed)
    assert len(fired) == 1 and restarts >= 1
    assert results == clean[0] and drops == clean[1]
    ref = _chaos_q5("repro", seed)
    assert ref[2] == fired
    assert ref[:2] == (results, drops)
