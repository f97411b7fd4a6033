"""The port's host->device bridge (``core/device_window.py``) against the
JAX package's.

NEXMark Q5 through ``aggregate(..., placement="device")``: the port's
``DeviceWindowProcessor`` runs with ``device="cpu"`` (the plain versions
of the kernels) and is held to the JAX package's device placement (JAX on
the CPU) and to both packages' host placement.  Then the processor alone,
driven the same way in both packages: its drop and collision counters,
its snapshot entries, the state a restore builds from them, and what
``_convert`` reads of a step's output.  Counts are compared exactly; the
few sums are of small integers, exact in float32, so no tolerance is
used anywhere.
"""

import importlib
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

STATE_KEYS = ("panes", "slot_frame", "watermark", "next_emit",
              "dropped_late", "dropped_conflict")


def _pkg(name):
    core = importlib.import_module(name + ".core")
    return dict(core=core,
                engine=importlib.import_module(name + ".core.engine"),
                nexmark=importlib.import_module(name + ".nexmark"),
                window=importlib.import_module(name + ".core.window"),
                processor=importlib.import_module(name + ".core.processor"))


def _device_kw(name, **kw):
    """Processor options; the port's runs on the CPU here."""
    return dict(kw, device="cpu") if name == "repro_torch" else kw


def _run_q5(name, placement, disorder=0, n_nodes=1, exactly_once=False,
            kill_at_result=None, rate=60_000, total=12_000):
    """test_device_window.py's ``_run_q5`` for either package: the result
    events as a sorted set of ``(ts, key, window_end, value)``, and the
    late drops of every tasklet."""
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
        placement=placement,
        device=_device_kw(name, n_key_buckets=64, batch_size=256))
    guarantee = core.GUARANTEE_EXACTLY_ONCE if exactly_once else \
        core.GUARANTEE_NONE
    job = cluster.submit(p.to_dag(), core.JobConfig(
        processing_guarantee=guarantee, snapshot_interval_s=0.02))
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
    drops = sum(getattr(t.processor, "late_dropped", 0)
                for t in job.execution.tasklets)
    return (sorted(set((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                       for ev in out)), drops)


# ---------------------------------------------------------------------------
# test_device_window.py's bridge tests, for the port
# ---------------------------------------------------------------------------


def test_q5_device_equals_host_ordered():
    h, drops_h = _run_q5("repro_torch", "host")
    d, drops_d = _run_q5("repro_torch", "device")
    assert h == d and len(h) > 0
    assert drops_h == drops_d == 0
    ref, ref_drops = _run_q5("repro", "device")
    assert d == ref and ref_drops == 0


def test_q5_device_equals_host_disordered():
    """Bounded skew with a covering watermark lag: identical window totals
    and late-drop accounting, in the port and against the reference."""
    h, drops_h = _run_q5("repro_torch", "host", disorder=40)
    d, drops_d = _run_q5("repro_torch", "device", disorder=40)
    assert h == d and len(h) > 0
    assert drops_h == drops_d == 0
    o, _ = _run_q5("repro_torch", "host", disorder=0)
    assert {(w, k): v for _t, k, w, v in d} == \
        {(w, k): v for _t, k, w, v in o}
    ref, ref_drops = _run_q5("repro", "device", disorder=40)
    assert d == ref and ref_drops == 0


@pytest.mark.slow
def test_q5_device_exactly_once_through_kill_node():
    """The device state travels in the snapshot (step-boundary barrier
    alignment); a node kill and restore reproduce the no-failure run, which
    equals the host placement's and the reference's device placement."""
    base, _ = _run_q5("repro_torch", "device", n_nodes=2)
    host_base, _ = _run_q5("repro_torch", "host", n_nodes=2)
    assert base == host_base and len(base) > 0
    a, _ = _run_q5("repro_torch", "device", n_nodes=2, exactly_once=True,
                   kill_at_result=30)
    assert a == base
    ref, _ = _run_q5("repro", "device", n_nodes=2)
    assert base == ref


def _summing_q5(name, placement):
    m = _pkg(name)
    core, nx = m["core"], m["nexmark"]
    rate, total = 60_000, 6_000
    gen = nx.NexmarkGenerator(rate=rate, n_keys=30)
    cluster = core.JetCluster(n_nodes=1, cooperative_threads=2,
                              clock=core.VirtualClock(auto_step=0.001))
    out = []
    p = core.Pipeline.create()
    (p.read_from(lambda: core.PacedGeneratorSource(
            gen, rate=rate, max_events=total), name="bids")
        .filter(nx.queries.is_bid)
        .with_key(nx.queries.bid_auction)
        .window(core.sliding(100, 20))
        .aggregate(core.summing(nx.queries.bid_price), placement=placement,
                   device=_device_kw(name, n_key_buckets=64, batch_size=128))
        .write_to(lambda: core.CollectorSink(out)))
    job = cluster.submit(p.to_dag(), core.JobConfig())
    for _ in range(4_000_000):
        if job.status == m["engine"].JOB_COMPLETED:
            break
        cluster.step()
    assert job.status == m["engine"].JOB_COMPLETED
    return sorted(set((ev.value.window_end, ev.key, ev.value.value)
                      for ev in out))


def test_q5_device_summing_variant():
    """The sum aggregate (vectorized price getter) bridges too; bid prices
    are integers, so the float32 sums are exact."""
    host = _summing_q5("repro_torch", "host")
    dev = _summing_q5("repro_torch", "device")
    assert host == dev and len(host) > 0
    assert dev == _summing_q5("repro", "device")


def test_device_placement_rejects_host_only_features():
    core = _pkg("repro_torch")["core"]
    p = core.Pipeline.create()
    keyed = (p.read_from(lambda: core.CollectorSink([]), name="s")
              .with_key(lambda v: v))
    with pytest.raises(ValueError):
        keyed.window(core.session(10)).aggregate(core.counting(),
                                                 placement="device")
    p2 = core.Pipeline.create()
    keyed2 = (p2.read_from(lambda: core.CollectorSink([]), name="s")
               .with_key(lambda v: v))
    with pytest.raises(ValueError):
        (keyed2.window(core.sliding(100, 10)).allowed_lateness(5)
            .aggregate(core.counting(), placement="device"))
    from repro_torch.core.window import SlidingWindowDef
    with pytest.raises(ValueError):
        core.DeviceWindowProcessor(SlidingWindowDef(100, 10), core.to_list(),
                                   device="cpu")


def test_device_defaults_to_cuda_and_raises_without_a_card():
    """Like every entry point of the port: on ``cuda`` unless the caller
    names a device, and no silent fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the processor would run on it")
    from repro_torch.core import DeviceWindowProcessor, counting
    from repro_torch.core.window import SlidingWindowDef
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceWindowProcessor(SlidingWindowDef(100, 20), counting())


# ---------------------------------------------------------------------------
# the processor alone, driven identically in both packages
# ---------------------------------------------------------------------------

#: window 100 / slide 20 (5 frames a window), ring of 7 slots, 16 buckets
#: for 40 auctions (collisions), batches of 32 rows
PROC_KW = dict(n_key_buckets=16, batch_size=32, max_windows_per_step=4,
               ring_margin=2)


def _script():
    """Blocks of (ts, key) and watermarks: on-time events, then events
    behind the emission front (late), events a ring span ahead of a live
    frame (conflicts), and keys that share a bucket (collisions)."""
    rng = np.random.RandomState(7)
    on_time = np.sort(rng.randint(0, 200, 150))
    late = rng.randint(0, 40, 9)
    ahead = rng.randint(340, 360, 11)
    more = np.sort(rng.randint(160, 300, 120))
    return [
        ("block", on_time, rng.randint(0, 40, on_time.size)),
        ("wm", 150),
        ("block", np.concatenate([late, ahead, more]),
         rng.randint(0, 40, late.size + ahead.size + more.size)),
        ("wm", 230),
    ]


def _make_proc(name, index=0):
    m = _pkg(name)
    proc = m["core"].DeviceWindowProcessor(
        m["window"].SlidingWindowDef(100, 20), m["core"].counting(),
        **_device_kw(name, **PROC_KW))
    outbox = m["processor"].Outbox(batch_limit=1_000_000)
    proc.init(outbox, m["processor"].ProcessorContext(
        "q5.device", index, index, 1, 0, 1, ()))
    return m, proc, outbox


def _forward(core, proc, wm):
    """Offer the watermark until the processor forwards it: the JAX
    package's steps run asynchronously, so it may first defer."""
    deadline = time.monotonic() + 120
    while not proc.try_process_watermark(core.Watermark(wm)):
        assert time.monotonic() < deadline, "the watermark never went through"
        time.sleep(0.001)


def _drive(name, script):
    """Feed ``script`` to a fresh processor; returns it, its outbox and
    every result it emitted as ``(ts, key, window_end, value)``."""
    m, proc, outbox = _make_proc(name)
    core = m["core"]
    emitted = []
    for op, *args in script:
        if op == "block":
            ts, keys = args
            inbox = m["processor"].Inbox()
            inbox.add(core.EventBlock(np.asarray(ts, np.int64),
                                      np.asarray(keys, np.int64)))
            proc.process(0, inbox)
        else:
            _forward(core, proc, args[0])
        emitted += outbox.drain()
    return proc, outbox, [(ev.ts, ev.key, ev.value.window_end,
                           ev.value.value) for ev in emitted]


def _state_numpy(state):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in state.items()}


def test_drop_and_collision_counters_equal_reference():
    """late_dropped, conflict_dropped and bucket_collisions, and what was
    emitted, after the same input; each counter is non-zero."""
    ref, _, ref_out = _drive("repro", _script())
    got, _, got_out = _drive("repro_torch", _script())
    assert got_out == ref_out and len(got_out) > 0
    for what in ("late_dropped", "conflict_dropped", "bucket_collisions"):
        assert getattr(got, what) == getattr(ref, what) > 0, what
    assert got._steps == ref._steps


def test_snapshot_entries_equal_reference():
    """_build_snapshot_entries after the same input: the same per-key
    frame lists and the same meta entry; the live state is not aliased."""
    ref, _, _ = _drive("repro", _script())
    got, _, _ = _drive("repro_torch", _script())
    want = ref._build_snapshot_entries()
    entries = got._build_snapshot_entries()
    assert entries == want
    assert sum(1 for k, _ in entries if k[0] == "k") > 10
    live = got.state["panes"].clone()
    got.state["panes"].add_(1.0)                # the entries hold copies
    assert got._build_snapshot_entries() != entries
    got.state["panes"].copy_(live)


def test_save_to_snapshot_then_restore_equals_reference():
    """save_to_snapshot (staged rows flushed, emission caught up) in both
    packages gives the same entries; finish_snapshot_restore from the same
    entries builds the same state: ints exact, panes exact."""
    script = _script()
    saved = {}
    for name in ("repro", "repro_torch"):
        proc, outbox, _ = _drive(name, script[:3])
        assert proc._n > 0                      # staged rows to flush
        assert proc.save_to_snapshot()
        saved[name] = list(outbox.snapshot_queue)
    assert saved["repro_torch"] == saved["repro"]
    states = {}
    for name in ("repro", "repro_torch"):
        _m, proc, _ = _make_proc(name, index=1)
        proc.restore_from_snapshot(saved["repro"])
        proc.finish_snapshot_restore()
        states[name] = _state_numpy(proc.state)
    got, want = states["repro_torch"], states["repro"]
    for k in STATE_KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["panes"].any()
    assert int(got["dropped_late"]) > 0


def test_restored_processor_runs_on_as_reference():
    """After a restore, the rest of the stream gives the same results and
    counters in both packages."""
    script = _script()
    ref, outbox, _ = _drive("repro", script[:3])
    assert ref.save_to_snapshot()
    entries = list(outbox.snapshot_queue)
    results = {}
    for name in ("repro", "repro_torch"):
        m, proc, box = _make_proc(name)
        proc.restore_from_snapshot(entries)
        proc.finish_snapshot_restore()
        _forward(m["core"], proc, 230)
        assert proc.complete()
        results[name] = ([(ev.ts, ev.key, ev.value.window_end,
                           ev.value.value) for ev in box.drain()],
                         proc.late_dropped, proc.conflict_dropped)
    assert results["repro_torch"] == results["repro"]
    assert len(results["repro"][0]) > 0


def test_convert_reads_only_the_valid_prefix():
    """A step's valid rows are exactly ``[0, rows)``; the rows past it
    (here filled with values and flagged valid) are never read."""
    _m, proc, _ = _make_proc("repro_torch")
    EB, K = 6, PROC_KW["n_key_buckets"]
    results = torch.zeros((EB, K))
    results[0, 3] = 2.0
    results[1, 5] = 1.0
    results[2:] = 9.0                           # past rows: never read
    out = {"results": results,
           "window_ends": torch.tensor([20, 40, 60, 80, 100, 120],
                                       dtype=torch.int32),
           "valid": torch.ones(EB, dtype=torch.bool), "rows": 2}
    proc._convert(out)
    got = [(ev.ts, ev.key, ev.value.window_end, ev.value.value)
           for ev in proc._emit_buf]
    assert got == [(19, 3, 20, 2), (39, 5, 40, 1)]
    proc._emit_buf.clear()
    proc._convert(dict(out, rows=0))
    assert not proc._emit_buf


def test_frontier_reaches_every_restoring_instance():
    """ROADMAP.md §3, F2: in a cluster the processor saves its emission
    frontier under every partition as well as in its ``("meta", idx)``
    entry, so an instance that restores keys but receives no meta entry
    still resumes at the saver's watermark and emission cursor (the
    reference's restarts that instance from -1 and re-fires windows whose
    first frames were evicted).  Without a partition count the entries
    are the reference's."""
    from repro_torch.core.dag import PARTITION_COUNT
    script = _script()
    m, proc, outbox = _make_proc("repro_torch")
    proc.ctx.partition_count = PARTITION_COUNT
    core = m["core"]
    for op, *args in script[:3]:
        if op == "block":
            inbox = m["processor"].Inbox()
            inbox.add(core.EventBlock(np.asarray(args[0], np.int64),
                                      np.asarray(args[1], np.int64)))
            proc.process(0, inbox)
        else:
            _forward(core, proc, args[0])
    assert proc.save_to_snapshot()
    entries = list(outbox.snapshot_queue)
    meta = [v for k, v in entries if k[0] == "meta"]
    front = {k[1]: v for k, v in entries if k[0] == "frontier"}
    assert len(meta) == 1 and sorted(front) == list(range(PARTITION_COUNT))
    assert all(proc.snapshot_partition(("frontier", p)) == p for p in front)
    want = {k: meta[0][k] for k in ("watermark", "next_emit", "top_ts")}
    assert want["next_emit"] > 0 and all(v == want for v in front.values())
    # the reference's entries are these without the frontier
    ref, ref_box, _ = _drive("repro", script[:3])
    assert ref.save_to_snapshot()
    assert [e for e in entries if e[0][0] != "frontier"] == \
        list(ref_box.snapshot_queue)
    # an instance owning a few keys and partitions, but not the meta
    keys = [e for e in entries if e[0][0] == "k"][:5]
    mine = keys + [(("frontier", p), front[p]) for p in (3, 70)]
    _m, other, _ = _make_proc("repro_torch", index=1)
    other.restore_from_snapshot(mine)
    other.finish_snapshot_restore()
    st = _state_numpy(other.state)
    assert int(st["watermark"]) == want["watermark"]
    assert int(st["next_emit"]) == want["next_emit"]
    assert other._top_ts == want["top_ts"]
    assert int(st["dropped_late"]) == 0         # counters ride the meta
    _m, bare, _ = _make_proc("repro_torch", index=2)
    bare.restore_from_snapshot(keys)
    bare.finish_snapshot_restore()
    assert int(_state_numpy(bare.state)["next_emit"]) == -1
