"""The benchmark's source and plain reference at small sizes (CPU)."""

import json
from pathlib import Path

import numpy as np
import pytest

from jetbench.reference import q5 as reference
from jetbench.source.nexmark import ReplayPool, events

HERE = Path(__file__).resolve().parents[1]
CFG = json.loads((HERE / "configs" / "q5-paper.json").read_text())
TINY = dict(CFG, window_ms=60, n_auctions=20, n_key_buckets=32,
            events_per_frame=64)
TRAFFIC = {"frames_per_step": 4, "pool_steps": 3}
SEEDS = [0, 7, 2**31 + 5, 2**33 + 11]


@pytest.mark.parametrize("name", ["q5-paper", "q5-paper-4rank"])
def test_bucket_map_is_a_bijection(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    K, m = cfg["n_key_buckets"], cfg["assumed"]["bucket_multiplier"]
    assert m % 2 == 1 and K & (K - 1) == 0
    buckets = (np.arange(K, dtype=np.int64) * m) % K
    assert np.array_equal(np.sort(buckets), np.arange(K))


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_mix_frames_and_replay(seed):
    ev = events(TINY, seed, np.arange(50 * 64))
    assert np.bincount(ev["kind"], minlength=3).tolist() == [64, 192, 2944]
    assert np.array_equal(ev["valid"], ev["kind"] == 2)
    # frame f holds exactly events [f * 64, (f + 1) * 64)
    assert np.array_equal(ev["ts"] // TINY["slide_ms"],
                          np.arange(50 * 64) // 64)
    again = events(TINY, seed, np.arange(50 * 64))
    assert all(np.array_equal(ev[k], again[k]) for k in ev)
    pool = ReplayPool(TINY, TRAFFIC, seed)
    b0, b3 = pool.batch_at(0), pool.batch_at(3)
    assert np.array_equal(b3["key"], b0["key"])
    assert np.array_equal(b3["ts"], b0["ts"] + pool.cycle_ms)


@pytest.mark.parametrize("world", [2, 4])
def test_instances_partition_each_step(world):
    whole = ReplayPool(TINY, TRAFFIC, 3)
    parts = [ReplayPool(TINY, TRAFFIC, 3, r, world) for r in range(world)]
    for step in range(4):
        want = whole.batch_at(step)
        got = [p.batch_at(step) for p in parts]
        for k in ("ts", "key", "valid"):
            merged = np.empty_like(want[k])
            for r, g in enumerate(got):
                merged[r::world] = g[k]
            assert np.array_equal(merged, want[k])
        # every instance spans the step's whole event time
        assert len({int(g["ts"].max()) // 10 for g in got}) == 1


def brute_force(ev, slide, F, n_windows, K):
    """Window L's count of each bucket, one event at a time."""
    out = np.zeros((n_windows, K), np.int64)
    for ts, key, ok in zip(ev["ts"].tolist(), ev["key"].tolist(),
                           ev["valid"].tolist()):
        if not ok:
            continue
        f = ts // slide
        for L in range(f, min(f + F, n_windows)):
            out[L, key] += 1
    return out


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_windows_against_a_brute_force_count(seed):
    pool = ReplayPool(TINY, TRAFFIC, seed)
    frames = pool.steps * pool.frames_per_step
    slide, F, K = TINY["slide_ms"], 6, TINY["n_key_buckets"]
    hist = reference.frame_histograms(pool.cols["ts"], pool.cols["key"],
                                      pool.cols["valid"], slide, frames, 0, K)
    n_steps = 7                     # past two pool cycles
    run = [pool.batch_at(i) for i in range(n_steps)]
    ev = {k: np.concatenate([b[k] for b in run]) for k in run[0]}
    n_windows = n_steps * pool.frames_per_step
    want = brute_force(ev, slide, F, n_windows, K)
    windows = reference.Windows(hist, F)
    assert np.array_equal(windows.counts(np.arange(n_windows)), want)
    # the multiplicity form the control uses gives the same counts
    assert np.array_equal(windows.multiplicity(np.arange(n_windows)) @ hist,
                          want)
    # exact results compare at 0; one altered count, one missing and one
    # doubled window do not
    ends = (np.arange(n_windows) + 1) * slide
    rows = want.astype(np.float32)
    last = n_windows * slide
    good = reference.compare([(ends, rows)], windows, slide, last)
    assert good == {"max_count_gap": 0.0, "windows_missing": 0,
                    "windows_extra": 0}
    bad = rows.copy()
    bad[3, 5] += 1
    assert reference.compare([(ends, bad)], windows, slide,
                             last)["max_count_gap"] == 1.0
    dropped = reference.compare([(ends[1:], rows[1:])], windows, slide, last)
    assert dropped["windows_missing"] == 1
    doubled = reference.compare([(ends, rows), (ends[:1], rows[:1])],
                                windows, slide, last)
    assert doubled["windows_extra"] == 1
    nan = rows.copy()
    nan[0, 0] = np.nan
    assert reference.compare([(ends, nan)], windows, slide,
                             last)["max_count_gap"] == float("inf")


def test_control_precisions():
    """At the paper's window (1 000 frames) a bucket's count passes 256, so
    counts kept in bfloat16 round: the control fails the exact comparison;
    float32 (and TF32, whose operands, pane counts and multiplicities, are
    exact below 2 048) meet it."""
    rng = np.random.default_rng(0)
    hist = rng.poisson(6.0, size=(296, 64)).astype(np.int64)
    windows = reference.Windows(hist, 1000)
    L = np.arange(900, 1200)
    slide = 10
    last = (L[-1] + 1) * slide
    gaps = {}
    for precision in ("float32", "tf32", "bfloat16"):
        res = list(reference.control_counts(windows, hist, L, slide,
                                            precision, device="cpu"))
        out = reference.compare(res, windows, slide, last)
        # windows before L[0] were not computed
        assert out["windows_missing"] == L[0]
        gaps[precision] = out["max_count_gap"]
    assert gaps["float32"] == 0 and gaps["tf32"] == 0
    assert gaps["bfloat16"] >= 1
