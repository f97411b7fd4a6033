"""The port's tracer (``repro_torch.tracing``) on small Q5 streams through
``StreamExecutor.run_stream`` on the CPU: where the spans open, how they
nest, what they count, that they change no result, and that under a
``torch.profiler`` they land in the exported trace around the operations
they hold."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import streaming as tst  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.nexmark import NexmarkGenerator  # noqa: E402

K, B, STEPS = 128, 256, 150
SPEC = dict(size_ms=1000, slide_ms=10, n_key_buckets=K,
            max_windows_per_step=4, ring_margin=8)
#: the span each span opens inside (None: at the top of the loop)
PARENT = {"stream.stage": None, "stream.step": None,
          "stream.accumulate": "stream.step", "stream.emit": "stream.step",
          "stream.emit.read": "stream.emit", "stream.collect": None,
          "stream.harvest": None, "stream.exchange": "stream.step"}


def q5_gen(start, n):
    blk = NexmarkGenerator(rate=25_600).gen_block(np.arange(start, start + n))
    return {"ts": blk.ts.astype(np.int32),
            "key": (blk.key % K).astype(np.int32),
            "value": np.ones(n, np.float32),
            "valid": blk.cols["kind"] == 2}            # bids only


def executor(tracer=None, mesh=None, exchange="reduce"):
    cfg = tst.StreamJobConfig(window=tst.VectorWindowSpec(**SPEC),
                              batch_size=B, exchange=exchange)
    return tst.StreamExecutor(cfg, mesh=mesh, device="cpu", tracer=tracer)


@pytest.fixture(scope="module")
def traced():
    tracer = tracing.Tracer()
    ex = executor(tracer)
    state, results = ex.run_stream(q5_gen, STEPS)
    return ex, tracer, state, results


def test_spans_nest_under_their_parents_and_steps(traced):
    ex, tracer, _, _ = traced
    spans = tracer.summary()["spans"]
    by_id = {s.id: s for s in spans}
    assert set(s.name for s in spans) == set(PARENT) - {"stream.exchange"}
    for s in spans:
        want = PARENT[s.name]
        if want is None:
            assert s.parent is None, s
            continue
        parent = by_id[s.parent]
        assert parent.name == want, s
        assert parent.step == s.step
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    # one step span an iteration, numbered in order; a step's spans share
    # its index
    steps = [s for s in spans if s.name == "stream.step"]
    assert [s.step for s in steps] == list(range(STEPS))
    collects = [s for s in spans if s.name == "stream.collect"]
    assert collects and all(
        steps[c.step].end_ns <= c.start_ns for c in collects)


@pytest.mark.parametrize("n_steps", [1, 2, 5])
def test_each_step_index_has_one_staging(n_steps):
    tracer = tracing.Tracer()
    ex = executor(tracer)
    for first in (0, n_steps):                # a second stream runs on
        ex.run_stream(q5_gen, n_steps)
        assert tracer.step == first + n_steps
    spans = tracer.summary()["spans"]
    steps = {s.step: s for s in spans if s.name == "stream.step"}
    stages = [s for s in spans if s.name == "stream.stage"]
    assert sorted(steps) == list(range(2 * n_steps))
    # the staging of the batch a step runs carries the step's index; batch
    # i + 1 is staged ahead of step i, after step i - 1
    assert sorted(s.step for s in stages) == sorted(steps)
    for s in stages:
        i = s.step % n_steps
        if i:
            assert s.end_ns <= steps[s.step - 1].start_ns
        if i > 1:
            assert steps[s.step - 2].end_ns <= s.start_ns
    # a harvest carries the index of the step after which it runs
    for s in spans:
        if s.name == "stream.harvest":
            assert steps[s.step].end_ns <= s.start_ns


def test_activate_nests_and_restores():
    outer, inner = tracing.Tracer(), tracing.Tracer()
    with tracing.activate(outer):
        with tracing.activate(inner):
            with tracing.active().span("stream.emit"):
                pass
        assert tracing.active() is outer
    assert tracing.active() is tracing.NULL
    assert inner.mark() == {"stream.emit": inner.mark()["stream.emit"]}
    assert outer.mark() == {}


def test_counts_match_the_work(traced):
    ex, tracer, _, results = traced
    totals = tracer.summary()["totals"]
    calls = {k: v["calls"] for k, v in totals.items()}
    # the reads are counted where they happen: one span a host sync
    assert calls["stream.emit.read"] == ex.host_syncs > STEPS
    for name in ("stream.step", "stream.accumulate", "stream.emit",
                 "stream.stage"):
        assert calls[name] == STEPS, name
    assert calls["stream.collect"] == len(results)
    assert calls["stream.harvest"] == \
        len(results) // ex.COLLECT_CHUNK + 1
    for name, t in totals.items():
        assert 0 <= t["self_ns"] <= t["total_ns"], name
    # a span without children is all self time; the step's children
    # account for all but its self time
    assert totals["stream.accumulate"]["self_ns"] == \
        totals["stream.accumulate"]["total_ns"]
    step = totals["stream.step"]
    assert step["total_ns"] - step["self_ns"] == \
        totals["stream.accumulate"]["total_ns"] \
        + totals["stream.emit"]["total_ns"]


@pytest.mark.parametrize("ring", [1, 16, 100])
def test_ring_stays_at_its_bound(ring, monkeypatch):
    monkeypatch.setattr(tracing, "RING", ring)
    tracer = tracing.Tracer()
    executor(tracer).run_stream(q5_gen, 20)
    summary = tracer.summary()
    opened = sum(t["calls"] for t in summary["totals"].values())
    assert opened > 100
    assert len(summary["spans"]) == ring
    # the ring keeps the last spans closed, and the sums cover them all
    assert summary["spans"][-1].name == "stream.harvest"
    assert summary["spans"][-1].id == opened - 1


def test_marks_differ_by_what_ran_between():
    tracer = tracing.Tracer()
    ex = executor(tracer)
    first = tracer.mark()
    assert first == {}
    ex.run_stream(q5_gen, 10)
    second = tracer.mark()
    ex.run_stream(q5_gen, 5)
    third = tracer.mark()
    assert third["stream.step"][0] - second["stream.step"][0] == 5
    assert second["stream.step"][0] == 10
    assert third["stream.step"][1] > second["stream.step"][1]
    # the second stream's steps are numbered on from the first's
    steps = [s.step for s in tracer.summary()["spans"]
             if s.name == "stream.step"]
    assert steps == list(range(15))


def test_null_tracer_records_nothing():
    ex = executor()
    assert ex.tracer is tracing.NULL
    ex.run_stream(q5_gen, 20)
    assert tracing.NULL.mark() == {}
    assert tracing.NULL.summary() == {"totals": {}, "spans": []}
    assert tracing.active() is tracing.NULL


def test_results_identical_with_and_without_a_tracer(traced):
    _, _, state, results = traced
    plain_state, plain = executor().run_stream(q5_gen, STEPS)
    assert len(plain) == len(results) > 0
    for (e0, r0), (e1, r1) in zip(plain, results):
        np.testing.assert_array_equal(e0, e1)
        assert r0.tobytes() == r1.tobytes()
    for k in plain_state:
        assert torch.equal(plain_state[k], state[k]), k


def test_spans_land_in_the_profiler_trace(tmp_path, monkeypatch):
    tracer = tracing.Tracer()
    ex = executor(tracer)
    ex.run_stream(q5_gen, 4)
    before, syncs = tracer.mark(), ex.host_syncs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ex.run_stream(q5_gen, 12)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("stream.")]
    counts = {}
    for e in notes:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    # every span closed under the profiler is in the trace, none from
    # before it, and one read annotation a host sync
    assert counts == {k: c - before.get(k, (0,))[0]
                      for k, (c, _, _) in tracer.mark().items()}
    assert counts["stream.step"] == 12
    assert counts["stream.emit.read"] == ex.host_syncs - syncs
    # emission's product (masks @ panes) runs inside a stream.emit span
    emits = [(e["ts"], e["ts"] + e["dur"]) for e in notes
             if e["name"] == "stream.emit"]
    mms = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::mm", "aten::matmul")]
    assert mms
    for e in mms:
        assert any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                   for lo, hi in emits), e
    # with no profiler running, no annotation is opened

    def no_annotation(name):
        raise AssertionError(f"annotation {name} opened without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", no_annotation)
    ex.run_stream(q5_gen, 3)
    assert tracer.mark()["stream.step"][0] == 19


@pytest.mark.parametrize("exchange,per_step", [("reduce", 1), ("route", 2)])
def test_exchange_spans_on_a_mesh(exchange, per_step, tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_data_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        tracer = tracing.Tracer()
        ex = executor(tracer, mesh=make_data_mesh("cpu"), exchange=exchange)
        ex.run_stream(q5_gen, 6)
    finally:
        dist.destroy_process_group()
    spans = tracer.summary()["spans"]
    by_id = {s.id: s for s in spans}
    exch = [s for s in spans if s.name == "stream.exchange"]
    assert len(exch) == 6 * per_step
    assert all(by_id[s.parent].name == "stream.step" for s in exch)
