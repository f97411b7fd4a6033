"""Driver ``stream_executor``: the device tier's ``StreamExecutor.run_stream``
on one card (``ranks`` 1) or on ``ranks`` spawned ranks, one card each,
over the configuration's exchange plan.

A window is one call of ``run_stream`` over ``steps`` steps, the step count
calibrated in set-up to fill the run's seconds.  The source is a
:class:`~jetbench.source.nexmark.ReplayPool`: numpy columns as the bridge
hands them over, so ``stage_batch``'s pinning copy lies on the measured
path.  Set-up warms up every shape the window uses (a stream's first
steps and its steady ones) on executors of their own, then calibrates.

With ``trace`` the window is the same call with spans put around the
calls it makes (``stage_batch``, ``step`` and the source, by instance
attributes that ``run_stream`` finds first), and the profiler on for the
window's last ``trace_steps`` steps.  Spans average over the steps before
the profiler starts: profiling slows every launch after it.

After the window, with the program's state freed, each rank holds what it
produced to the plain reference (``jetbench/reference/q5.py``) over its
own key buckets.  Each rank returns a small record; results never leave
the rank and never touch the disk.
"""

from __future__ import annotations

import gc
import importlib
import math
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..reference import q5 as reference
from ..source.nexmark import ReplayPool, events
from ..yardstick import roofline, trace as tracing


def run(job: Dict) -> List[Dict]:
    """One record per rank, in rank order."""
    ranks = int(job["cfg"]["ranks"])
    if ranks == 1:
        return [_rank_entry(0, 1, torch.device(job["device"]), job)]
    from repro_torch.launch.mesh import spawn_ranks
    backend = "nccl" if job["device"] == "cuda" else "gloo"
    return spawn_ranks(_rank_entry, ranks, backend=backend,
                       device=job["device"], args=(job,),
                       timeout_s=job["timeout_s"])


def _rank_entry(rank: int, world: int, dev: torch.device, job: Dict
                ) -> Dict:
    for name in job.get("before", ()):
        module, attr = name.split(":")
        getattr(importlib.import_module(module), attr)()
    return _rank_run(rank, world, dev, job)


class _Timed:
    """``fn`` with each call's host seconds kept, and with ``trace`` a
    profiler annotation ``jetbench.<name>`` around it."""

    def __init__(self, name: str, fn, trace: bool):
        self.fn, self.trace = fn, trace
        self.label = f"{tracing.SPAN_PREFIX}{name}"
        self.seconds: List[float] = []
        self.starts: List[float] = []

    def __call__(self, *args, **kwargs):
        if self.trace:
            with torch.profiler.record_function(self.label):
                t = time.perf_counter()
                out = self.fn(*args, **kwargs)
        else:
            t = time.perf_counter()
            out = self.fn(*args, **kwargs)
        self.starts.append(t)
        self.seconds.append(time.perf_counter() - t)
        return out


def _rank_run(rank: int, world: int, dev: torch.device, job: Dict) -> Dict:
    from repro_torch.kernels.route import route_pack
    from repro_torch.kernels.window_agg import accumulate_
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.streaming import (StreamExecutor, StreamJobConfig,
                                       VectorWindowSpec)

    cfg, traffic, seed = job["cfg"], job["traffic"], job["seed"]
    marks = {"entered": time.time()}
    torch.set_num_threads(1)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    spec = VectorWindowSpec(
        size_ms=cfg["window_ms"], slide_ms=cfg["slide_ms"],
        n_key_buckets=cfg["n_key_buckets"],
        max_windows_per_step=cfg["max_windows_per_step"],
        ring_margin=cfg["ring_margin"])
    pool = ReplayPool(cfg, traffic, seed, rank, world)
    jcfg = StreamJobConfig(
        window=spec, batch_size=pool.batch, exchange=cfg["exchange"],
        route_capacity_factor=cfg["route_capacity_factor"])
    mesh = make_data_mesh(dev.type) if world > 1 else None
    marks["pool"] = time.time()

    def agree_max(x: float) -> float:
        """The largest ``x`` over the ranks (every rank runs the same
        number of steps)."""
        if world == 1:
            return x
        t = torch.tensor([x], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    # set-up: every shape of the window, then the step count
    StreamExecutor(jcfg, mesh=mesh, device=dev).run_stream(
        pool.event_gen(), int(traffic["warmup_steps"]))
    sync()
    marks["warm"] = time.time()
    n_cal = int(traffic["calibrate_steps"])
    t = time.perf_counter()
    StreamExecutor(jcfg, mesh=mesh, device=dev).run_stream(
        pool.event_gen(), n_cal)
    sync()
    per_step = agree_max((time.perf_counter() - t) / n_cal)
    marks["calibrated"] = time.time()
    steps = max(int(traffic["min_steps"]),
                math.ceil(job["seconds"] / per_step))
    trace_steps = min(int(traffic["trace_steps"]), steps // 2) \
        if job["trace"] else 0

    ex = StreamExecutor(jcfg, mesh=mesh, device=dev)
    source = _Timed("source", pool.event_gen(), job["trace"])
    prof = None
    if job["trace"]:
        stage = ex.stage_batch = _Timed("stage", ex.stage_batch, True)
        step_fn = _Timed("step", ex.step, True)

        def step(*args, **kwargs):
            if len(step_fn.seconds) == steps - trace_steps:
                nonlocal prof
                marks.update(stage=len(stage.seconds),
                             source=len(source.seconds),
                             t=time.perf_counter())
                acts = [torch.profiler.ProfilerActivity.CPU]
                if cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                marks["profiler_start_s"] = time.perf_counter() - marks["t"]
            return step_fn(*args, **kwargs)
        ex.step = step
    launches0 = (accumulate_.launches, route_pack.launches)
    gc.collect()
    if world > 1:
        agree_max(0.0)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    window_start = time.time()
    t0 = time.perf_counter()
    state, results = ex.run_stream(source, steps)
    sync()
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    rec = {
        "rank": rank, "world": world, "steps": steps,
        "events": steps * pool.rows, "window_s": window_s,
        "window_start": window_start,
        "marks": {k: marks[k] for k in ("entered", "pool", "warm",
                                        "calibrated", "profiler_start_s")
                  if k in marks},
        "source_ms": 1e3 * float(np.mean(source.seconds)),
        # ms a step in each quarter of the window, from the source's calls
        "quarters_ms": [1e3 * float(np.mean(np.diff(q))) for q in
                        np.array_split(np.array(source.starts), 4)],
        "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)
        if cuda else 0,
        "counters": {"host_syncs": ex.host_syncs,
                     "emit_rounds": ex.emit_rounds,
                     "accumulate_launches":
                         accumulate_.launches - launches0[0],
                     "route_pack_launches":
                         route_pack.launches - launches0[1]},
        "dropped": {"late": int(state["dropped_late"]),
                    "conflict": int(state["dropped_conflict"])},
    }
    capacity = ex.capacity
    del state, ex
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if job["trace"]:
        pre = steps - trace_steps
        rec["spans"] = {
            "stage": 1e3 * float(np.mean(stage.seconds[:marks["stage"]])),
            "step": 1e3 * float(np.mean(step_fn.seconds[:pre])),
            "source": 1e3 * float(np.mean(source.seconds[:marks["source"]])),
        }
        inside = (sum(stage.seconds[:marks["stage"]])
                  + sum(step_fn.seconds[:pre])
                  + sum(source.seconds[:marks["source"]]))
        rec["spans"]["results"] = 1e3 * (marks["t"] - t0 - inside) / pre
        with tempfile.TemporaryDirectory(prefix="jetbench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            rec["trace"] = tracing.summarize(path)
        rec["trace"]["steps"] = trace_steps
    rec.update(_check(cfg, pool, seed, rank, world, steps, results,
                      rec.get("trace"), capacity))
    return rec


def _check(cfg, pool: ReplayPool, seed: int, rank: int, world: int,
           steps: int, results, trace, capacity: int) -> Dict:
    """The reference's verdict on this rank's key buckets, and the bytes
    of the profiled steps' kernel calls (counted from the same inputs)."""
    K, slide = cfg["n_key_buckets"], cfg["slide_ms"]
    lo, hi = rank * K // world, (rank + 1) * K // world
    if world == 1:
        full = pool.cols
    else:
        full = events(cfg, seed, np.arange(pool.steps * pool.batch))
    frames = pool.steps * pool.frames_per_step
    hist = reference.frame_histograms(full["ts"], full["key"], full["valid"],
                                      slide, frames, lo, hi)
    windows = reference.Windows(hist, cfg["window_ms"] // slide)
    # the final watermark: the least, over the source instances, of the
    # latest valid event each read in the last step
    j, cycle = (steps - 1) % pool.steps, (steps - 1) // pool.steps
    ts = full["ts"][j * pool.batch:(j + 1) * pool.batch]
    valid = full["valid"][j * pool.batch:(j + 1) * pool.batch]
    wm = min(int(ts[r::world][valid[r::world]].max())
             for r in range(world)) + cycle * pool.cycle_ms
    out = {"checks": reference.compare(results, windows, slide,
                                       wm // slide * slide)}
    if trace is not None:
        frame = np.arange(pool.batch) // cfg["events_per_frame"]
        ring = cfg["window_ms"] // slide + cfg["ring_margin"]
        acc_rows = pool.batch if world == 1 else world * capacity
        acc = route = 0
        for i in range(steps - trace["steps"], steps):
            j = i % pool.steps
            sl = slice(j * pool.batch, (j + 1) * pool.batch)
            key, ok = full["key"][sl], full["valid"][sl]
            mine = ok & (key >= lo) & (key < hi)
            cells = np.unique(frame[mine] * K + key[mine]).size
            acc += roofline.accumulate_bytes(acc_rows, 4, ring, cells)
            route += roofline.route_pack_bytes(pool.rows, world, capacity)
        out["kernel_bytes"] = {"accumulate": acc, "route_pack": route}
    return out
