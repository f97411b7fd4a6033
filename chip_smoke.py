#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments, on a machine with a
CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. card: its name and power limit (``nvidia-smi``);
2. build: every kernel of the path from ``src/repro_torch/kernels/csrc``
   with ``nvcc``;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   card, at the main path's shape and at edge shapes;
4. main path: device-tier NEXMark Q5 through ``StreamExecutor.run_stream``
   at the paper's configuration (10 s window sliding by 10 ms over 10 000
   auctions, 16 384 key buckets, 65 536 events per step), held exactly
   against an independent numpy oracle; the kernels' launch counts are
   zeroed just before and read just after;
5. latency: per-step event-to-result latency, one step at a time;
6. summing: Q5 summing bid prices with TF32 switched on globally, held
   against a float64 oracle (emission must stay full float32);
7. timing: each kernel at the main path's shape beside its plain version,
   its library yardstick and its memory bound, then a profiled stretch of
   the main path (device time by kernel, the device's idle share) — last,
   because the profiler slows every launch after it;
8. the numbers line, the kernels line, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.window_agg import (  # noqa: E402
    window_agg, window_agg_into_, window_agg_plain_into_)
from repro_torch.nexmark import NexmarkGenerator  # noqa: E402
from repro_torch.streaming import (  # noqa: E402
    StreamExecutor, StreamJobConfig, VectorWindowSpec)

#: H100 SXM device memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12

# the paper's Q5 (nexmark/queries.py:187) over its §7.1 stream
WINDOW_MS, SLIDE_MS = 10_000, 10
N_AUCTIONS, K = 10_000, 16_384
B = 65_536                           # seqs per step
RATE = B * 1000 // SLIDE_MS          # events/s: one step = one 10 ms frame
SPEC = VectorWindowSpec(size_ms=WINDOW_MS, slide_ms=SLIDE_MS,
                        n_key_buckets=K, max_windows_per_step=8,
                        ring_margin=8)
F32_TOL = dict(rtol=1e-6, atol=1e-5)
MAIN_STEPS = 1500        # the last 500 windows it emits span a full 10 s
LATENCY_STEPS = 10_000   # a p99.99 needs 10 000 samples
SUMMING_STEPS = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def q5_batch(gen: NexmarkGenerator, step: int, price: bool = False):
    """Step ``step``'s events as numpy columns: bids are valid, the auction
    id is the key bucket (16 384 buckets hold 10 000 auctions one each)."""
    blk = gen.gen_block(np.arange(step * B, (step + 1) * B))
    bid = blk.cols["kind"] == 2
    value = blk.value if price else np.ones(B)
    return {"ts": blk.ts.astype(np.int32),
            "key": (blk.key % K).astype(np.int32),
            "value": value.astype(np.float32), "valid": bid}


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean time per call between CUDA events around ``iters``
    back-to-back calls: where launches are short, the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, iters: int):
    """``{kernel name: (device ms per call, launches per call)}`` of ``fn``
    from the profiler's device records: kernel time alone, without the host
    gaps between launches that ``cuda_ms`` also counts."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / iters / 1e3, e.count / iters)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def device_ms(fn, iters: int = 50):
    """Device time per call summed over every kernel ``fn`` launches; None
    where the profiler recorded no device time (not measured)."""
    total = sum(ms for ms, _ in profiled(fn, iters).values())
    return total if total > 0 else None


# -- phase 1 -----------------------------------------------------------------
def card() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {name} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    return name, smi


# -- phase 2 -----------------------------------------------------------------
def build() -> None:
    """Build (or load, where the checkout has it already) every kernel of
    the path; print the time and ptxas' register and spill report."""
    for name in ("window_agg",):
        fresh = not _build.library_path(name).exists()
        t0 = time.perf_counter()
        _build.load(name)
        log(f"build: {name} {'built' if fresh else 'loaded'} in "
            f"{time.perf_counter() - t0:.2f} s")
        text = _build.library_path(name).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# -- phase 3 -----------------------------------------------------------------
def check_window_agg(dev) -> dict:
    """window_agg against its plain version: counts exactly, f32 sums to
    rtol 1e-6 (atomics add in no fixed order), bf16 values to the same
    tolerance (both sides widen the same bf16 values to f32)."""
    rng = np.random.RandomState(0)
    R = SPEC.ring_len
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    path = q5_batch(gen, 7)
    path_t = {k: torch.from_numpy(v).to(dev) for k, v in path.items()}
    path_slots = (path_t["ts"] // SLIDE_MS) % R

    def rand(n, k, r, dtype=torch.float32, oob=False):
        lo_k, hi_k, lo_r, hi_r = (-4, k + 9, -2, r + 3) if oob else (0, k, 0,
                                                                      r)
        return (torch.from_numpy(rng.randint(lo_k, hi_k, n).astype(np.int32)),
                torch.from_numpy(rng.randint(lo_r, hi_r, n).astype(np.int32)),
                torch.from_numpy(rng.randn(n).astype(np.float32)).to(dtype),
                torch.from_numpy(rng.rand(n) > 0.2), k, r)

    cases = {
        "path_q5_counts": (path_t["key"], path_slots.to(torch.int32),
                           path_t["value"], path_t["valid"], K, R),
        "path_random_f32": rand(B, K, R),
        "empty": rand(0, 100, 4),
        "ragged": rand(1025, 129, 3),
        "out_of_range": rand(5000, 100, 6, oob=True),
        "bf16_values": rand(8192, 512, 16, dtype=torch.bfloat16),
    }
    max_err = 0.0
    for name, (keys, slots, vals, valid, k, r) in cases.items():
        keys, slots, vals, valid = (t.to(dev) for t in (keys, slots, vals,
                                                        valid))
        before = window_agg.launches
        panes = window_agg_into_(torch.zeros((r, k), device=dev), keys,
                                 slots, vals, valid)
        kr = window_agg(keys, slots, vals, valid, k, r)
        torch.cuda.synchronize()
        launched = window_agg.launches - before
        if launched != (2 if keys.numel() else 0):
            raise AssertionError(f"{name}: {launched} launches")
        want = window_agg_plain_into_(torch.zeros((r, k), device=dev), keys,
                                      slots, vals, valid)
        torch.cuda.synchronize()
        if name == "path_q5_counts":
            if not (torch.equal(panes, want) and torch.equal(kr.t(), want)):
                raise AssertionError("path counts differ from plain version")
        else:
            torch.testing.assert_close(panes, want, **F32_TOL)
            torch.testing.assert_close(kr.t(), want, **F32_TOL)
        err = max(float((panes - want).abs().max()),
                  float((kr.t() - want).abs().max()))
        max_err = max(max_err, err)
        log(f"window_agg {name}: N={keys.numel()} K={k} R={r} "
            f"{vals.dtype} max_abs_err={err:.3g} ok")

    return {"name": "window_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/window_agg.cu",
            "replaces": "src/repro/kernels/window_agg.py:54",
            "max_abs_err": max_err}


# -- phase 4 -----------------------------------------------------------------
def pinned_batches(gen, n_steps: int):
    """``n_steps`` Q5 batches generated ahead into pinned host memory, and
    the per-frame bid histogram of each (the oracle's input)."""
    cols = {"ts": torch.int32, "key": torch.int32, "value": torch.float32,
            "valid": torch.bool}
    bufs = {k: torch.empty((n_steps, B), dtype=d, pin_memory=True)
            for k, d in cols.items()}
    hist = np.zeros((n_steps, K), np.int64)
    for i in range(n_steps):
        b = q5_batch(gen, i)
        if not (b["ts"] // SLIDE_MS == i).all():
            raise AssertionError(f"step {i} spans more than frame {i}")
        for k in cols:
            bufs[k][i].numpy()[:] = b[k]
        hist[i] = np.bincount(b["key"][b["valid"]], minlength=K)
    return [{k: bufs[k][i] for k in cols} for i in range(n_steps)], hist


def window_oracle(hist: np.ndarray) -> np.ndarray:
    """Row L: the sum over frames L-F+1..L (window end (L+1)*slide), from
    the per-frame histograms alone."""
    F = SPEC.frames_per_window
    csum = np.concatenate([np.zeros((1, hist.shape[1]), hist.dtype),
                           np.cumsum(hist, axis=0)])
    L = np.arange(hist.shape[0])
    return csum[L + 1] - csum[np.maximum(L + 1 - F, 0)]


def check_against_oracle(results, oracle, n_steps: int, exact: bool):
    got = {}
    for ends, rows in results:
        for e, row in zip(ends.tolist(), rows):
            if e in got:
                raise AssertionError(f"window end {e} emitted twice")
            got[e] = row
    want_ends = [(L + 1) * SLIDE_MS for L in range(n_steps - 1)]
    if sorted(got) != want_ends:
        raise AssertionError(f"emitted {len(got)} windows, expected "
                             f"{len(want_ends)}")
    for L, e in enumerate(want_ends):
        if exact:
            if not np.array_equal(got[e], oracle[L].astype(np.float32)):
                bad = np.flatnonzero(got[e] != oracle[L])
                raise AssertionError(f"window end {e}: {bad.size} auctions "
                                     f"differ, e.g. {bad[:5]}")
        else:
            np.testing.assert_allclose(got[e], oracle[L], rtol=1e-5, atol=0,
                                       err_msg=f"window end {e}")
    return len(want_ends)


def main_path(dev, n_steps: int) -> dict:
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    t0 = time.perf_counter()
    batches, hist = pinned_batches(gen, n_steps)
    log(f"main path: {n_steps} batches of {B} events generated into pinned "
        f"memory in {time.perf_counter() - t0:.1f} s")
    cfg = StreamJobConfig(window=SPEC, batch_size=B)

    def feed(start, size):
        return batches[start // size]

    # warm-up run (cuBLAS handles, allocator pools) outside the count
    StreamExecutor(cfg).run_stream(feed, min(32, n_steps))
    torch.cuda.synchronize()

    ex = StreamExecutor(cfg)
    window_agg.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, results = ex.run_stream(feed, n_steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = window_agg.launches

    oracle = window_oracle(hist)
    n_windows = check_against_oracle(results, oracle, n_steps, exact=True)
    full = max(0, n_steps - SPEC.frames_per_window)
    drops = (int(state["dropped_late"]), int(state["dropped_conflict"]))
    if drops != (0, 0):
        raise AssertionError(f"dropped (late, conflict) = {drops}")
    if launches < n_steps:
        raise AssertionError(f"window_agg launched {launches} times in "
                             f"{n_steps} steps")
    bids = int(hist.sum())
    out = {
        "steps": n_steps, "events_per_step": B,
        "windows_checked": n_windows, "full_windows_checked": full,
        "panes_mb": state["panes"].numel() * 4 / 1e6,
        "steps_per_s": n_steps / dt, "wall_ms_per_step": dt / n_steps * 1e3,
        "events_per_s": n_steps * B / dt,
        "bids_per_s": bids / dt,
        "emit_rounds_per_step": ex.emit_rounds / n_steps,
        "host_syncs_per_step": ex.host_syncs / n_steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "window_agg_launches": launches,
    }
    log(f"main path: {n_windows} windows ({full} full) equal the numpy "
        f"oracle exactly; drops 0; {json.dumps(out)}")

    return out


# -- phase 5 -----------------------------------------------------------------
def latency(dev, n_steps: int, warmup: int = 50) -> dict:
    """device_q5_latency's clock: from the batch existing on the host to
    the step's window results being on the host, one step at a time.  Each
    sample splits into staging (pinning and enqueuing the copies), the step
    (it waits for the device at each emission round) and the sink copy."""
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    ex = StreamExecutor(StreamJobConfig(window=SPEC, batch_size=B))
    state = ex.init_state()
    parts_us = np.empty((n_steps, 3))
    for i in range(warmup + n_steps):
        batch = q5_batch(gen, i)
        t_gen = time.perf_counter()
        staged, count = ex.stage_batch(batch)
        t_staged = time.perf_counter()
        state, out = ex.step(state, staged, valid_count=count)
        t_stepped = time.perf_counter()
        if out["rows"]:
            out["results"][:out["rows"]].cpu()          # sink
        else:
            torch.cuda.synchronize()
        t_emit = time.perf_counter()
        if i >= warmup:
            parts_us[i - warmup] = np.array(
                [t_staged - t_gen, t_stepped - t_staged,
                 t_emit - t_stepped]) * 1e6
    lat_us = parts_us.sum(axis=1)
    pcts = [50, 99, 99.99]
    p50, p99, p9999 = np.percentile(lat_us, pcts) / 1e3
    res = {"samples": n_steps, "p50_ms": p50, "p99_ms": p99,
           "p99.99_ms": p9999, "max_ms": lat_us.max() / 1e3,
           "drops": int(state["dropped_late"] + state["dropped_conflict"])}
    for j, part in enumerate(("stage", "step", "sink")):
        res[f"{part}_p50_p99_p9999_ms"] = (
            np.percentile(parts_us[:, j], pcts) / 1e3).tolist()
    if res["drops"]:
        raise AssertionError(f"latency run dropped {res['drops']} events")
    log(f"latency: {json.dumps(res)}")
    return res


# -- phase 6 -----------------------------------------------------------------
def summing(dev, n_steps: int) -> dict:
    """Sum bid prices per auction with TF32 on globally: pane values reach
    tens of thousands per frame, which TF32's 10-bit mantissa would round;
    the executor pins its emission product to full float32."""
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    batches, hist = [], np.zeros((n_steps, K))
    for i in range(n_steps):
        b = q5_batch(gen, i, price=True)
        batches.append(b)
        hist[i] = np.bincount(b["key"][b["valid"]],
                              weights=b["value"][b["valid"]].astype(
                                  np.float64), minlength=K)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ex = StreamExecutor(StreamJobConfig(window=SPEC, batch_size=B))
        state, results = ex.run_stream(lambda s, size: batches[s // size],
                                       n_steps)
        n = check_against_oracle(results, window_oracle(hist), n_steps,
                                 exact=False)
        # control: the same kind of product outside the pin, where TF32
        # may round it (0/1 masks over per-frame price sums)
        masks = (np.random.RandomState(0).rand(8, SPEC.ring_len) < 0.5
                 ).astype(np.float32)
        panes = np.resize(hist, (SPEC.ring_len, K)).astype(np.float32)
        tf32 = (torch.from_numpy(masks).to(dev)
                @ torch.from_numpy(panes).to(dev)).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    exact = masks.astype(np.float64) @ panes.astype(np.float64)
    ctrl = float(np.abs(tf32 - exact).max() / np.abs(exact).max())
    if not ctrl > 1e-5:
        # TF32 did not take effect outside the pin, so passing under it
        # would prove nothing about the pin
        raise AssertionError(f"TF32 control within rtol 1e-5 ({ctrl:.3g}): "
                             f"the phase does not exercise TF32")
    res = {"steps": n_steps, "windows_checked": n,
           "max_pane_value": float(hist.max()),
           "tf32_control_rel_err": ctrl}
    log(f"summing under TF32: {n} windows of bid-price sums within rtol "
        f"1e-5 of the float64 oracle; {json.dumps(res)}")
    return res


# -- phase 7 -----------------------------------------------------------------
def time_window_agg(dev) -> dict:
    """window_agg at the main path's shape (one step's Q5 batch added into
    the (R, K) panes, as accumulate calls it) beside its plain version, its
    library yardstick and its memory bound.  Runs after the main path: the
    profiler, once started, slows every later launch."""
    R = SPEC.ring_len
    b = q5_batch(NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS), 7)
    keys, vals, valid = (torch.from_numpy(b[k]).to(dev)
                         for k in ("key", "value", "valid"))
    slots = ((torch.from_numpy(b["ts"]).to(dev) // SLIDE_MS) % R).to(
        torch.int32)
    panes = torch.zeros((R, K), device=dev)
    # library yardstick: one index_add_ on the flattened panes, given the
    # flat index and masked values it needs ready-made
    flat_idx = torch.where(valid, slots.long() * K + keys.long(), 0)
    flat_val = torch.where(valid, vals, 0.0)
    flat = panes.view(-1)
    fns = {"kernel": lambda: window_agg_into_(panes, keys, slots, vals,
                                              valid),
           "plain": lambda: window_agg_plain_into_(panes, keys, slots, vals,
                                                   valid),
           "library": lambda: flat.index_add_(0, flat_idx, flat_val)}
    # CUDA events over 200 back-to-back calls, in turns
    times = {}
    for label in ("plain", "kernel", "library", "kernel", "plain"):
        times.setdefault(label, []).append(cuda_ms(fns[label], iters=200))
    dev_only = {label: device_ms(fn) for label, fn in fns.items()}
    # bytes this batch needs: each input read once, and one read and one
    # write of every (slot, key) cell the contributing rows touch
    cells = torch.unique(flat_idx[valid]).numel()
    n = keys.numel()
    bytes_moved = n * (4 + 4 + vals.element_size() + 1) + 8 * cells
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    log(f"window_agg timing at N={n} K={K} R={R} ({int(valid.sum())} bids, "
        f"{cells} cells): events ms {json.dumps(times)}; device time alone "
        f"(profiler) ms {json.dumps(dev_only)}; bound {bound_ms:.6f} ms "
        f"({bytes_moved} B at 3.35 TB/s)")
    return {"ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": min(times["library"]),
            "device_ms": dev_only["kernel"],
            "plain_device_ms": dev_only["plain"],
            "library_device_ms": dev_only["library"]}


def profile_main_path(dev, wall_ms_per_step: float, n_steps: int = 50):
    """Where a main-path step's time goes: device time by kernel over a
    profiled stretch, against the unprofiled run's wall time per step."""
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    batches, _ = pinned_batches(gen, n_steps)
    cfg = StreamJobConfig(window=SPEC, batch_size=B)
    kernels = profiled(lambda: StreamExecutor(cfg).run_stream(
        lambda s, size: batches[s // size], n_steps), iters=1)
    busy = sum(ms for ms, _ in kernels.values()) / n_steps
    res = {"wall_ms_per_step": wall_ms_per_step,
           "device_ms_per_step": busy,
           "device_idle_share": 1 - busy / wall_ms_per_step,
           "device_launches_per_step": sum(
               c for _, c in kernels.values()) / n_steps}
    log(f"main path per step: {json.dumps(res)}; top device time per step:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, launches) in top:
        log(f"  {ms / n_steps:.5f} ms  x{launches / n_steps:.2f}  "
            f"{name[:100]}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name, smi = card()
    build()
    kernel = check_window_agg(dev)
    path = main_path(dev, MAIN_STEPS)
    kernel["launches"] = path["window_agg_launches"]
    lat = latency(dev, LATENCY_STEPS)
    summ = summing(dev, SUMMING_STEPS)
    kernel.update(time_window_agg(dev))
    prof = profile_main_path(dev, path["wall_ms_per_step"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"main_path": path, "latency": lat, "summing": summ,
                      "profile": prof}))
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
