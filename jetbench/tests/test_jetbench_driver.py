"""Whole runs of the benchmark on the CPU at a small size (the kernels'
plain versions): the result line, the metrics, and ``correct`` coming out
false with the timed path broken underneath it."""

import json

import pytest
import torch

from jetbench import harness

SMALL = {"cfg": {"window_ms": 200, "n_auctions": 50, "n_key_buckets": 64,
                 "events_per_frame": 256},
         "traffic": {"pool_steps": 5, "warmup_steps": 6,
                     "calibrate_steps": 6, "min_steps": 24,
                     "trace_steps": 8}}
ONE, FOUR = "q5-paper.catchup8", "q5-paper-4rank.catchup8"
SEED = 2**31 + 977
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def with_pending(cell):
    """``BENCHMARK.json`` with the cell that ``jetbench/pending/`` holds
    (measured, not yet in the benchmark) merged in."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    frag = harness.load_json(harness.HERE / "pending" / f"{cell}.json")
    for key in ("configs", "workloads", "per_layer"):
        bench[key] = bench[key] + frag[key]
    for m in bench["per_layer"]:
        if m["name"] in frag["per_layer_shared"]:
            m["workloads"] = m["workloads"] + [cell]
    return bench


def run(cell, trace=False, job=None, seconds=0.2, benchmark=None):
    over = dict(SMALL, job=job or {})
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides=over, benchmark=benchmark)["line"]


def reported(cell, trace, bench=None):
    bench = bench or harness.load_json(harness.ROOT / "BENCHMARK.json")
    return {m["name"] for m in harness.metrics_of(bench, cell, trace)}


def test_one_card_end_to_end_line():
    line = run(ONE)
    assert line["correct"] is True
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line["metrics"]) == reported(ONE, False)
    assert line["metrics"]["events_per_s"]["value"] > 0
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in line["checks"].values())
    json.dumps(line)


def test_one_card_traced_line():
    line = run(ONE, trace=True)
    assert line["correct"] is True
    # the CPU has no device trace: the device metrics are left out
    assert set(line["metrics"]) == reported(ONE, True) - {
        "accumulate_roofline", "device_idle"}
    assert line["metrics"]["host_syncs_per_step"]["value"] == 2.0
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert len(line["breakdown"]["idle_gaps"]) <= 10


def _keep_state(spec, state, *args, **kwargs):
    return state


def _half_batch(original):
    def accumulate(spec, state, ts, key, value, valid, wm_hint=None):
        n = ts.shape[0] // 2
        return original(spec, state, ts[:n], key[:n], value[:n] * 2,
                        valid[:n], wm_hint)
    return accumulate


def _altered(original):
    def emit(spec, state):
        state, out = original(spec, state)
        if out["rows"]:
            out["results"][0, 0] += 1
        return state, out
    return emit


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_one_card_faults_fail(fault, monkeypatch):
    from repro_torch.streaming import window
    if fault == "state_unchanged":
        monkeypatch.setattr(window, "accumulate", _keep_state)
    elif fault == "half_batch":
        monkeypatch.setattr(window, "accumulate",
                            _half_batch(window.accumulate))
    else:
        monkeypatch.setattr(window, "emit", _altered(window.emit))
    line = run(ONE)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def exchange_left_out():
    """Every rank keeps its own send buffer: no event reaches its owner."""
    from repro_torch.streaming import collectives
    collectives.all_to_all = lambda tr, x: x.contiguous().clone()


def test_four_ranks_sound_then_without_the_exchange():
    bench = with_pending(FOUR)
    line = run(FOUR, trace=True, benchmark=bench)
    assert line["correct"] is True and line["device"]["count"] == 4
    # the CPU has no device trace: the device metrics are left out
    assert set(line["metrics"]) == reported(FOUR, True, bench) - {
        "accumulate_roofline", "device_idle", "exchange_ms",
        "route_pack_roofline"}
    broken = run(FOUR, job={"before": [f"{__name__}:exchange_left_out"]},
                 benchmark=bench)
    assert broken["correct"] is False
    assert broken["checks"]["max_count_gap"]["value"] > 0


@pytest.mark.cuda
def test_one_card_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = harness.run_cell(ONE, SEED, 0.5, True, device="cuda",
                            overrides=SMALL)["line"]
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["accumulate_roofline"]["value"] <= 100
