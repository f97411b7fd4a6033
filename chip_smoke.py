#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments, on a machine with a
CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

``python3 chip_smoke.py --ranks`` runs phases 1, 2 and 9 alone (on a
host with 4 cards: the ranks over NCCL, a card each); ``python3
chip_smoke.py --engine`` runs phases 1, 2 and 10 alone; ``python3
chip_smoke.py --faults`` runs phases 1, 2 and 12 alone.

It drives five paths of the port: device-tier NEXMark Q5 on one card
(``window_agg``'s library: one fused ``accumulate`` launch a step), LM
serving (``decode_attention``), Q5 across 4 ranks under the route
exchange (one ``route_pack`` cluster launch and one ``accumulate`` a rank
a step), the paper's main path: ``queries.q5(placement="device")``
through the port's host engine into its ``DeviceWindowProcessor`` (one
``accumulate`` a device step), and that path through seeded faults, a
durable snapshot chain and a cold start (one ``accumulate`` a device
step, the replays included).  The ``window_agg`` op, ``route_counts``
and ``route_offsets`` are held in phases 3 and 11 as the TPU kernels'
counterparts and launch on no path.  Phases, in order of number; phase
12 runs between 10 and 11, before 11's profiler slows every launch
after it.  Any failure ends the run with a non-zero exit and no result
line:

1. card: its name and power limit (``nvidia-smi``);
2. build: every kernel from ``src/repro_torch/kernels/csrc`` with
   ``nvcc``, one process per source, all started together;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   card, at its path's shapes and at edge shapes (the fused accumulate
   with the whole window state compared; route_pack also over memory
   poisoned first, and as the route plan calls it, without positions);
4. Q5 path: device-tier NEXMark Q5 through ``StreamExecutor.run_stream``
   at the paper's configuration (10 s window sliding by 10 ms over 10 000
   auctions, 16 384 key buckets, 65 536 events per step), held exactly
   against an independent numpy oracle, with exactly one accumulate
   launch a step;
5. latency: Q5's per-step event-to-result latency, one step at a time;
6. summing: Q5 summing bid prices with TF32 switched on globally, held
   against a float64 oracle (emission must stay full float32);
7. serve path: ``BatchedLMServer`` decoding qwen2-1.5b at full width
   (28 layers, random weights from a seed) for 16 requests of 256 prompt
   and 256 new tokens over 8 slots; then one full-depth step with TF32
   switched on globally must give the same logits;
8. card against CPU: qwen2-1.5b at full width cut to 4 layers, the same
   weights on both, 16 teacher-forced steps, logits compared;
9. Q5 across 4 ranks at the paper's configuration, one process a rank
   (spawned): NCCL with a card a rank where the host has 4 cards, else the
   4 ranks share this card over gloo.  The route plan runs 1 500 steps,
   each rank generating only its own slice of every batch, and every
   rank's result columns must equal the numpy oracle's exactly with zero
   drops and exactly ``route_pack`` and ``accumulate`` once a step; then
   the reduce plan, 200 steps (its ``psum_scatter`` moves the 66 MB of
   full-width panes a rank a step, through the host on gloo); then the
   route step with the fused accumulate against the plain one, in turns,
   and a profiled stretch of each on rank 0;
10. engine path: ``queries.q5(placement="device")`` through the port's
    ``JetCluster``, in process, on the card.  (a) On a virtual clock, the
    reference test's stream (40 auctions, 12 000 events, window 100 /
    slide 20): device placement equals host placement exactly, with no
    late drops, and two nodes with exactly-once snapshots through a
    ``kill_node`` equal the run without a failure (the restore builds the
    window state on the card).  (b) At the paper's shape on the wall
    clock (10 s window sliding by 10 ms, 10 000 auctions, 16 384 key
    buckets, batches of 16 384), paced at 100 000 events/s: every
    ``(window_end, auction)`` count equal to a numpy oracle, no drops or
    bucket collisions, one ``accumulate`` a device step; it prints the
    events/s and results/s sustained, whether the run kept pace, the
    sink's event-to-result latency, the vertices' time shares and the
    device time a step;
11. timing: Q5's wall a step with the fused accumulate against the plain
    one, in turns; each kernel at its path's shape beside its plain
    version, its library yardstick and its bound (``decode_attention``
    also at the ``decode_32k`` shape);
    ptxas' registers, spills and shared memory of the new kernels and
    route_pack's cluster; then a profiled stretch of each path (device
    time by kernel, the device's idle share; Q5 also with the plain
    accumulate) — last, because the profiler slows every launch after
    it;
12. fault tolerance: (a) phase 10 (a)'s stream with device placement on
    two nodes, exactly-once, a durable snapshot chain and its output
    through a transactional and an idempotent sink into an external
    collector, through ``ChaosSchedule.from_seed`` for 3 seeds (kill,
    raise and the three corruptions of the chain head): each equal to the
    clean run and to host placement, every result delivered once; then
    the coordinator dies and a fresh cluster cold-starts the job from the
    chain onto the card.  (b) Phase 10 (b)'s configuration (event time
    cut to 3 s), exactly-once with a 1 s snapshot interval and a durable
    chain, through a seeded kill after the first committed snapshot, a
    flipped byte in the chain head, then the coordinator's death and a
    cold start that must fall back past the corrupted head: every count
    equal to the numpy oracle, no drops; it prints each snapshot's build,
    spill and bytes, each restore's seconds and the recovery gaps.  (c)
    ``backend="mp"``, host placement, 4 worker processes, in a subprocess
    that cannot see the card: tests/test_chaos.py's stream and (b)'s
    stream cut to one frame, each clean and through a seeded SIGKILL of a
    worker, equal to the in-process run, no ring left; and
    ``q5(placement="device")`` on ``mp`` refused;

then the numbers line, the kernels line, the card line, and last the
result line ``{"ok": true, "device": {...}}``.

Before each path runs, the launch counts of its kernels are set to 0 (in
each rank's process for the 4-rank path); they are read just after.
Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import array
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CollectorSink, DeviceWindowProcessor, GUARANTEE_EXACTLY_ONCE,
    GUARANTEE_NONE, JetCluster, JobConfig, PacedGeneratorSource, Processor,
    VirtualClock, WallClock)
from repro_torch.core import JOB_FAILED, Job, RestartPolicy  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    JOB_COMPLETED, ExecutionContext)
from repro_torch.core.shm_ring import RING_NAME_PREFIX  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.kernels import _build, decode_attn  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.route import (  # noqa: E402
    pack_cluster, pack_plan, route_counts, route_counts_plain, route_offsets,
    route_offsets_plain, route_pack, route_pack_plain)
from repro_torch.kernels.window_agg import (  # noqa: E402
    accumulate_, accumulate_plain_, window_agg, window_agg_plain_into_)
from repro_torch.launch.mesh import (  # noqa: E402
    make_data_mesh, spawn_ranks)
from repro_torch.launch.serve import BatchedLMServer  # noqa: E402
from repro_torch.models import lm, transformer  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)
from repro_torch.nexmark import NexmarkGenerator, queries  # noqa: E402
from repro_torch.runtime.worker_proc import (  # noqa: E402
    MultiprocessBackend)
from repro_torch.runtime.chaos import (  # noqa: E402
    CORRUPTION_KINDS, KIND_CORRUPT_FLIP, KIND_KILL, KIND_RAISE,
    ChaosController, ChaosSchedule, Fault)
from repro_torch.snapshot import (  # noqa: E402
    ExternalCollector, IdempotentSink, TransactionalSink)
from repro_torch.state import DurableSnapshotStore  # noqa: E402
from repro_torch.streaming import (  # noqa: E402
    StreamExecutor, StreamJobConfig, VectorWindowSpec)
from repro_torch.streaming import window as stream_window  # noqa: E402
from repro_torch.streaming.collectives import psum_scatter  # noqa: E402
from repro_torch.streaming.window import window_state_init  # noqa: E402

#: H100 SXM device memory rate and dense peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
KERNELS = ("window_agg", "decode_attn", "route")

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
# Q5 across 4 ranks (phase 9): each owns K / 4 = 4 096 key buckets, so
# ranks 0 and 1 each own 41 % of the 10 000 auctions and rank 3 none (the
# paper's layout); the route plan's C = 8 192 cells a destination hold a
# source's share of about 6 200 bids
RANKS = 4
ROUTE_STEPS = 1500
#: the reduce plan moves 66 MB of panes a rank a step (through the host on
#: gloo, about 170 ms a step on one shared card): 200 steps check it
REDUCE_STEPS = 200
RANK_PROFILE_STEPS = 30
#: the route step with the fused accumulate against the plain one, in turns
ROUTE_AB_STEPS = 100

# LM serving (repro/launch/serve.py) of qwen2-1.5b at full width, float32
ARCH = "qwen2-1.5b"
SLOTS, N_REQUESTS, PROMPT_LEN, MAX_NEW, MAX_SEQ = 8, 16, 256, 256, 1024
#: kernel against plain version in every type, as tests/test_kernels.py
#: holds the Pallas kernel to its oracle in f32: the kernel sums in another
#: order and scales q where the plain version scales the scores; both widen
#: the same bf16 inputs to f32 and sum in f32
ATTN_TOL = 2e-5
#: kernel against the library yardstick, which computes in the input type
LIB_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: card against CPU at full width: every sum (1536-wide rows, 8960-wide
#: MLP rows, the 151 936-wide head) runs in another order on each side, and
#: the differences grow through 4 layers
CPU_TOL = dict(rtol=1e-3, atol=1e-3)
CPU_LAYERS, CPU_STEPS = 4, 16
#: the profiled serve stretch covers positions PROFILE_AT to PROFILE_AT +
#: PROFILE_STEPS - 1 (second wave of requests, no admission in between)
PROFILE_AT, PROFILE_STEPS = 600, 20


def log(msg: str) -> None:
    print(msg, flush=True)


def q5_events(gen: NexmarkGenerator, seqs: np.ndarray, price: bool = False):
    """The events of sequence numbers ``seqs`` as numpy columns: bids are
    valid, the auction id is the key bucket (16 384 buckets hold 10 000
    auctions one each)."""
    blk = gen.gen_block(seqs)
    bid = blk.cols["kind"] == 2
    value = blk.value if price else np.ones(len(seqs))
    return {"ts": blk.ts.astype(np.int32),
            "key": (blk.key % K).astype(np.int32),
            "value": value.astype(np.float32), "valid": bid}


def q5_batch(gen: NexmarkGenerator, step: int, price: bool = False):
    """Step ``step``'s events (one 10 ms frame of the stream)."""
    return q5_events(gen, np.arange(step * B, (step + 1) * B), price)


def rank_seqs(step: int, rank: int, ranks: int = RANKS) -> np.ndarray:
    """Rank ``rank``'s contiguous slice of step ``step``'s sequence numbers
    (the executor's ``P("data")`` slice)."""
    b_loc = B // ranks
    start = step * B + rank * b_loc
    return np.arange(start, start + b_loc)


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


def zero_counts() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    window_agg.launches = 0
    accumulate_.launches = 0
    decode_attention.launches = 0
    route_counts.launches = 0
    route_offsets.launches = 0
    route_pack.launches = 0


def launch_counts() -> dict:
    return {"window_agg": window_agg.launches,
            "accumulate": accumulate_.launches,
            "decode_attention": decode_attention.launches,
            "route_counts": route_counts.launches,
            "route_offsets": route_offsets.launches,
            "route_pack": route_pack.launches}


@contextlib.contextmanager
def plain_accumulate():
    """Within the block, the streaming tier's accumulate runs its plain
    version on the card (about 35 PyTorch launches) instead of the fused
    kernel: the yardstick of phase 11's comparisons, never a path's run."""
    fused = stream_window.accumulate_
    stream_window.accumulate_ = accumulate_plain_
    try:
        yield
    finally:
        stream_window.accumulate_ = fused


# -- phase 2 -----------------------------------------------------------------
def build() -> None:
    """Build (or load, where the checkout has it already) every kernel, one
    ``nvcc`` per source, all started together; print the times and ptxas'
    register and spill report."""
    def one(name):
        fresh = not _build.library_path(name).exists()
        t0 = time.perf_counter()
        _build.load(name)
        return fresh, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        done = dict(zip(KERNELS, pool.map(one, KERNELS)))
    log(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, (fresh, dt) in done.items():
        log(f"build: {name} {'built' if fresh else 'loaded'} in {dt:.2f} s")
        text = _build.library_path(name).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# -- phase 3 -----------------------------------------------------------------
def check_window_agg(dev) -> dict:
    """The window_agg op against its plain version (counts exactly, f32
    sums to rtol 1e-6: atomics add in no fixed order; bf16 values to the
    same tolerance, as both sides widen the same values to f32)."""
    rng = np.random.RandomState(0)
    R = SPEC.ring_len
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    path = q5_batch(gen, 7)
    path_t = {k: torch.from_numpy(v).to(dev) for k, v in path.items()}
    path_slots = ((path_t["ts"] // SLIDE_MS) % R).to(torch.int32)

    def rand(n, k, r, dtype=torch.float32, oob=False):
        lo_k, hi_k, lo_r, hi_r = (-4, k + 9, -2, r + 3) if oob else (0, k, 0,
                                                                      r)
        return (torch.from_numpy(rng.randint(lo_k, hi_k, n).astype(np.int32)),
                torch.from_numpy(rng.randint(lo_r, hi_r, n).astype(np.int32)),
                torch.from_numpy(rng.randn(n).astype(np.float32)).to(dtype),
                torch.from_numpy(rng.rand(n) > 0.2), k, r)

    cases = {
        "path_q5_counts": (path_t["key"], path_slots, path_t["value"],
                           path_t["valid"], K, R),
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
        kr = window_agg(keys, slots, vals, valid, k, r)
        torch.cuda.synchronize()
        if window_agg.launches - before != (1 if keys.numel() else 0):
            raise AssertionError(f"window_agg {name}: launches off")
        want = window_agg_plain_into_(torch.zeros((r, k), device=dev), keys,
                                      slots, vals, valid).t()
        if name == "path_q5_counts":
            if not torch.equal(kr, want):
                raise AssertionError(f"{name}: counts differ from the plain "
                                     f"version")
        else:
            torch.testing.assert_close(kr, want, **F32_TOL)
        err = float((kr - want).abs().max()) if kr.numel() else 0.0
        max_err = max(max_err, err)
        log(f"window_agg {name}: N={keys.numel()} K={k} R={r} "
            f"{vals.dtype} max_abs_err={err:.3g} ok")
    return {"name": "window_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/window_agg.cu",
            "replaces": "src/repro/kernels/window_agg.py:54",
            "max_abs_err": max_err}


#: a ring of 16 slots of 512 buckets: one batch spans it more than twice
SMALL_SPEC = VectorWindowSpec(size_ms=80, slide_ms=10, n_key_buckets=512,
                              ring_margin=8)


def acc_kw(spec) -> dict:
    return dict(slide_ms=spec.slide_ms,
                frames_per_window=spec.frames_per_window, wm_lag=spec.wm_lag,
                frontier_from_data=spec.frontier_from_data)


def q5_state(dev, rng, frames: int = 7) -> dict:
    """A Q5 state after ``frames`` steps: frames 0.. in the ring with some
    counts, the first window (end 10 ms) emitted."""
    state = window_state_init(SPEC, device="cpu")
    state["slot_frame"][:frames] = torch.arange(frames, dtype=torch.int32)
    state["panes"][:frames] = torch.from_numpy(
        rng.randint(0, 3, (frames, K)).astype(np.float32))
    state["next_emit"].fill_(10)
    state["watermark"].fill_(frames * SLIDE_MS - 1)
    return {k: v.to(dev) for k, v in state.items()}


def accumulate_cases(dev) -> dict:
    """``{name: (spec, state, [((ts, key, value, valid), wm_hint), ...],
    exact)}``: a Q5 step at the paper's shape (counts, and bid prices), two
    frames sharing a slot in one batch, conflicts, late rows, keys -1, K
    and K + 17, every wm_hint form, no data-driven frontier with wm_lag >
    0, bf16 and f16 values, two calls back to back, and no rows."""
    rng = np.random.RandomState(5)
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)

    def rows(ts, key, valid=None, value=None, dtype=torch.float32):
        n = len(ts)
        arrays = (np.asarray(ts, np.int32), np.asarray(key, np.int32),
                  np.ones(n, np.float32) if value is None
                  else np.asarray(value, np.float32),
                  np.ones(n, bool) if valid is None
                  else np.asarray(valid, bool))
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        t[2] = t[2].to(dtype)
        return tuple(t)

    def small_state(spec=SMALL_SPEC, occupied=None, next_emit=-1):
        state = window_state_init(spec, device="cpu")
        for slot, frame in (occupied or {}).items():
            state["slot_frame"][slot] = frame
        state["next_emit"].fill_(next_emit)
        return {k: v.to(dev) for k, v in state.items()}

    def mixed(n, dtype=torch.float32, counts=True):
        # frames 0..40 over 16 slots: frames share slots within the batch,
        # half the ring's occupants conflict, frames below 7 are late, keys
        # run past both ends of [0, K) (-1, K and K + 17 among them)
        r, k = SMALL_SPEC.ring_len, SMALL_SPEC.n_key_buckets
        occupied = {i: i + r for i in range(r) if rng.rand() < 0.5}
        key = rng.randint(-20, k + 40, n)
        key[:3] = [-1, k, k + 17]
        return small_state(occupied=occupied, next_emit=150), rows(
            rng.randint(0, 410, n), key, rng.rand(n) < 0.9,
            None if counts else rng.randn(n), dtype)

    q5 = q5_batch(gen, 7)
    q5_prices = q5_batch(gen, 7, price=True)
    mixed_state, mixed_rows = mixed(50_000)
    k = SMALL_SPEC.n_key_buckets
    lag_spec = dataclasses.replace(SMALL_SPEC, wm_lag=25,
                                   frontier_from_data=False)
    cases = {
        "q5_step": (SPEC, q5_state(dev, rng), [(rows(**q5), None)], True),
        "q5_step_prices": (SPEC, q5_state(dev, rng),
                           [(rows(**q5_prices), None)], False),
        "two_frames_one_slot": (SMALL_SPEC, small_state(), [(rows(
            [25, 185, 27, 183, 21], [1, 2, 1, 4, 9]), None)], True),
        "conflicts": (SMALL_SPEC, small_state(occupied={2: 2, 5: 21},
                                              next_emit=30), [(rows(
            [25, 185, 55, 211, 22, 189], [1, 2, 3, 4, 5, 6]), None)], True),
        "late_rows": (SMALL_SPEC, small_state(next_emit=150), [(rows(
            [35, 69, 70, 71, 99, 12], [0, 1, 2, 3, 4, 5],
            [1, 1, 1, 1, 1, 0]), None)], True),
        "keys_out_of_range": (SMALL_SPEC, small_state(), [(rows(
            [5, 5, 5, 75, 75, 155, 155], [-1, k, k + 17, -1, k, k + 17,
                                          -3 * k]), None)], True),
        "mixed_counts": (SMALL_SPEC, mixed_state, [(mixed_rows, None)],
                         True),
        "hint_int": (SMALL_SPEC, small_state(), [(rows([25, 31], [1, 2]),
                                                  1234)], True),
        "hint_tensor": (SMALL_SPEC, small_state(), [(rows([25, 31], [1, 2]),
                        torch.tensor(1234, dtype=torch.int32, device=dev))],
                        True),
        "hint_below_frontier": (SMALL_SPEC, small_state(), [(rows(
            [25, 310], [1, 2]), 7)], True),
        "no_frontier_wm_lag": (lag_spec, small_state(lag_spec), [(rows(
            [25, 310, 47], [1, 2, 3]), 200)], True),
        "two_calls": (SMALL_SPEC, mixed(5_000)[0], [
            (mixed(5_000)[1], None), (mixed(5_000)[1], 33)], True),
        "no_rows": (lag_spec, small_state(lag_spec), [(rows([], []), 90)],
                    True),
    }
    for dtype in (torch.bfloat16, torch.float16):
        state, r = mixed(20_000, dtype, counts=False)
        cases[str(dtype)[6:]] = (SMALL_SPEC, state, [(r, None)], False)
    return cases


def check_accumulate(dev) -> dict:
    """The fused accumulate against accumulate_plain_ on the card from the
    same state: slot_frame, the watermark, next_emit and the counters
    exactly, the panes exactly for counts and to rtol 1e-6 for sums; one
    launch a call, none for no rows.  Returns its kernels-line entry with
    the largest pane error."""
    max_err = 0.0
    for name, (spec, state, calls, exact) in accumulate_cases(dev).items():
        got = {k: v.clone() for k, v in state.items()}
        want = {k: v.clone() for k, v in state.items()}
        for (ts, key, value, valid), hint in calls:
            before = accumulate_.launches
            accumulate_(got, ts, key, value, valid, wm_hint=hint,
                        **acc_kw(spec))
            torch.cuda.synchronize()
            if accumulate_.launches - before != (1 if ts.numel() else 0):
                raise AssertionError(f"accumulate {name}: launches off")
            accumulate_plain_(want, ts, key, value, valid, wm_hint=hint,
                              **acc_kw(spec))
            for k in want:
                if k == "panes" and not exact:
                    torch.testing.assert_close(got[k], want[k], **F32_TOL)
                elif not torch.equal(got[k], want[k]):
                    raise AssertionError(f"accumulate {name}: {k} differs "
                                         f"from the plain version")
        err = float((got["panes"] - want["panes"]).abs().max())
        max_err = max(max_err, err)
        drops = (int(got["dropped_late"]), int(got["dropped_conflict"]))
        log(f"accumulate {name}: N={sum(c[0][0].numel() for c in calls)} "
            f"R={spec.ring_len} K={spec.n_key_buckets} "
            f"{calls[0][0][2].dtype} calls={len(calls)} drops={drops} "
            f"watermark={int(got['watermark'])} max_abs_err={err:.3g} ok")
    return {"name": "accumulate", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/window_agg.cu",
            "replaces": "src/repro/kernels/window_agg.py:54",
            "replaces_jnp": "src/repro/streaming/window.py:116",
            "max_abs_err": max_err}


def cache_view(rng, b, s, hk, dh, dtype, dev):
    """k or v as the model holds it, ``(B, S, Hk, dh)``, permuted to the
    op's ``(B, Hk, S, dh)`` view (read in place, never copied)."""
    t = torch.from_numpy(rng.randn(b, s, hk, dh).astype(np.float32))
    return t.to(dev, dtype).permute(0, 2, 1, 3)


def check_decode_attention(dev) -> dict:
    """decode_attention against its plain version at the serve shape
    (8 slots, 12 query heads over 2 kv heads, dh 128, S = 1024) through
    the cache's seq-major view, and at the kernel's edges: n_valid of 1,
    around one stage (64 positions) and one ring (192 positions in
    bf16/f16, 128 in f32 at dh 128), the last split ending inside a stage,
    G = 1, 7, 16 and 24 (one to three groups of 8 query rows), dh 16 to
    256, f16 and bf16 at the serve and decode_32k widths with pos >= S;
    every type within 2e-5.  Then one cache twice (no new tensor map, the
    same bits), k and v with different strides, and views TMA cannot
    describe (ValueError, no launch).  First, the library's block for
    every type and dh 16 to 256 against the wrapper's CPU mirror
    (``decode_block``)."""
    rng = np.random.RandomState(1)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    for dt in (f32, bf16, f16):
        for dh in (16, 64, 128, 256):
            card = decode_block(dt, dh, dev.index or 0)
            log(f"decode_attention block {str(dt)[6:]} dh {dh}: {card}")
    cases = [(f"serve_{str(dt)[6:]}_pos{pos}", 8, 12, 2, 1024, 128, pos, dt)
             for dt in (f32, bf16) for pos in (0, 511, 1023)]
    cases += [("g1", 1, 16, 16, 1024, 128, 700, f32),
              ("hk8", 1, 24, 8, 1024, 128, 1023, f32),
              ("ragged_s", 2, 12, 2, 1000, 128, 999, f32),
              ("pos_past_s", 2, 12, 2, 1000, 128, 1500, f32)]
    cases += [(f"n_valid{pos + 1}_{str(dt)[6:]}", 8, 12, 2, 1024, 128, pos,
               dt) for dt, edges in ((bf16, (62, 63, 64, 191, 192)),
                                     (f16, (63, 64)),
                                     (f32, (62, 63, 64, 127, 128)))
              for pos in edges]
    cases += [("split_ends_in_stage_bf16", 1, 12, 2, 1000, 128, 999, bf16),
              ("split_ends_in_stage_f32", 1, 12, 2, 1000, 128, 999, f32),
              ("g1_bf16", 2, 16, 16, 700, 128, 650, bf16),
              ("g7_bf16", 2, 56, 8, 777, 128, 776, bf16),
              ("g7_f32", 2, 56, 8, 777, 128, 776, f32),
              ("g16_bf16", 2, 16, 1, 900, 128, 899, bf16),
              ("g16_f32", 2, 16, 1, 900, 128, 899, f32),
              ("g24_f16", 1, 24, 1, 500, 128, 400, f16)]
    cases += [(f"dh{dh}_{str(dt)[6:]}", 4, 8, 2, 600, dh, 599, dt)
              for dh in (16, 64, 256) for dt in (bf16, f16, f32)]
    cases += [(f"serve_{str(dt)[6:]}_past_s", 8, 12, 2, 1024, 128, 1500, dt)
              for dt in (bf16, f16)]
    d32 = SHAPES["decode_32k"]
    cases += [(f"decode_32k_{str(dt)[6:]}_past_s", d32.global_batch, 12, 2,
               d32.seq_len, 128, d32.seq_len + 100, dt) for dt in (bf16, f16)]
    errs = {f32: 0.0, bf16: 0.0, f16: 0.0}
    gen = torch.Generator(device=dev).manual_seed(11)
    for name, b, h, hk, s, dh, pos, dt in cases:
        if b * s > 100_000:       # decode_32k: drawn on the card
            q = torch.randn(b, h, dh, generator=gen, device=dev).to(dt)
            k, v = (torch.randn(b, s, hk, dh, generator=gen, device=dev)
                    .to(dt).permute(0, 2, 1, 3) for _ in range(2))
        else:
            q = torch.from_numpy(rng.randn(b, h, dh).astype(np.float32)).to(
                dev, dt)
            k, v = (cache_view(rng, b, s, hk, dh, dt, dev) for _ in range(2))
        before = decode_attention.launches
        got = decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        if decode_attention.launches != before + 1:
            raise AssertionError(f"{name}: the kernel did not launch once")
        want = decode_attention_plain(q, k, v, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        err = float((got - want).abs().max())
        errs[dt] = max(errs[dt], err)
        log(f"decode_attention {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"pos {pos} {dt} max_abs_err={err:.3g} ok")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    decode_attention_twice(dev)
    errs[f32] = max(errs[f32], decode_attention_mixed_views(dev))
    decode_attention_rejects(dev)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
            "replaces": "src/repro/kernels/decode_attn.py:65",
            "max_abs_err": errs[f32], "max_abs_err_bf16": errs[bf16],
            "max_abs_err_f16": errs[f16]}


def decode_block(dtype, dh, idx):
    """The library's block for ``dtype`` and ``dh`` (tile, stages, shared
    memory; blocks an SM by the occupancy query), which the wrapper plans
    with on a card, held to the wrapper's CPU mirror that the plan's CPU
    tests read: equal, but for blocks an SM, where the mirror is the floor
    that ``__launch_bounds__`` and shared memory guarantee (registers may
    allow more) and must be exact at dh 128, the path's."""
    cfg = decode_attn.kernel_config(dtype, dh)
    card = decode_attn.card_config(dtype, dh, idx)
    blocks_ok = (card.blocks_per_sm == cfg.blocks_per_sm if dh == 128
                 else card.blocks_per_sm >= cfg.blocks_per_sm)
    if not blocks_ok or dataclasses.replace(
            card, blocks_per_sm=cfg.blocks_per_sm) != cfg:
        raise AssertionError(f"decode_attention block for {dtype} dh {dh}: "
                             f"the card's {card}, the wrapper's mirror {cfg}")
    return card


def decode_attention_twice(dev) -> None:
    """One cache read twice at one position, then at another: the second
    call encodes no tensor map and gives the same bits, and the arrival
    counters carry nothing over (each result against the plain version)."""
    rng = np.random.RandomState(2)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(rng.randn(8, 12, 128).astype(np.float32)).to(
            dev, dt)
        k, v = (cache_view(rng, 8, 1024, 2, 128, dt, dev) for _ in range(2))
        first = decode_attention(q, k, v, 900)
        encoded = decode_attn.maps_encoded()
        second = decode_attention(q, k, v, 900)
        third = decode_attention(q, k, v, 300)
        torch.cuda.synchronize()
        if decode_attn.maps_encoded() != encoded:
            raise AssertionError("a second call on one cache encoded a map")
        if not torch.equal(first, second):
            raise AssertionError("two calls on one cache differ")
        for got, pos in ((second, 900), (third, 300)):
            torch.testing.assert_close(
                got, decode_attention_plain(q, k, v, pos), rtol=ATTN_TOL,
                atol=ATTN_TOL)
        log(f"decode_attention twice on one cache {dt}: maps cached, "
            f"counters clean, ok")


def decode_attention_mixed_views(dev) -> float:
    """k through the seq-major cache view and v head-major contiguous, and
    the other way round (each gets its own tensor map), within 2e-5; the
    largest f32 error."""
    rng = np.random.RandomState(3)
    err32 = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(rng.randn(4, 12, 128).astype(np.float32)).to(
            dev, dt)
        seq = cache_view(rng, 4, 700, 2, 128, dt, dev)
        head = torch.from_numpy(rng.randn(4, 2, 700, 128).astype(
            np.float32)).to(dev, dt)
        for k, v in ((seq, head), (head, seq)):
            before = decode_attention.launches
            got = decode_attention(q, k, v, 650)
            torch.cuda.synchronize()
            if decode_attention.launches != before + 1:
                raise AssertionError("mixed views: the kernel did not launch")
            want = decode_attention_plain(q, k, v, 650)
            torch.testing.assert_close(got, want, rtol=ATTN_TOL,
                                       atol=ATTN_TOL)
            err = float((got - want).abs().max())
            if dt == torch.float32:
                err32 = max(err32, err)
            log(f"decode_attention k strides {k.stride()} v strides "
                f"{v.stride()} {dt}: max_abs_err={err:.3g} ok")
    return err32


def decode_attention_rejects(dev) -> None:
    """Views TMA cannot describe raise ValueError and launch nothing."""
    q = torch.zeros(1, 4, 8, device=dev)
    flat = torch.zeros(1 + 64 * 2 * 8, device=dev)
    bad = {"base off 16 bytes":
           (q, flat[1:].view(1, 64, 2, 8).permute(0, 2, 1, 3)),
           "row stride 36 bytes":
           (q, torch.zeros(1, 64, 2, 9, device=dev)[..., :8].permute(
               0, 2, 1, 3)),
           "bf16 rows of 24 bytes":
           (torch.zeros(1, 4, 12, device=dev, dtype=torch.bfloat16),
            torch.zeros(1, 2, 64, 12, device=dev, dtype=torch.bfloat16))}
    before = decode_attention.launches
    for what, (qq, kv) in bad.items():
        try:
            decode_attention(qq, kv, kv, 5)
        except ValueError as e:
            if "16" not in str(e):
                raise AssertionError(f"{what}: {e}") from e
            log(f"decode_attention rejects {what}: {e}")
        else:
            raise AssertionError(f"{what}: no ValueError")
    if decode_attention.launches != before:
        raise AssertionError("a rejected view launched the kernel")


def check_route(dev) -> list:
    """route_counts and route_offsets against their plain versions at the
    route plan's shape (a rank's 16 384 events over 4 destinations), the
    reference test shapes, a key-bucket histogram (a whole Q5 batch over
    16 384 buckets) and edges; route_pack (one cluster launch, nothing
    else) at the path's inputs, N of 0, 1, 1 023, 1 024, 1 025, 16 384 and
    2^20, 1 to 32 destinations, overflow into the last destination, keys
    outside [0, K), C = 1, and over memory poisoned first.  All integers:
    held exactly."""
    rng = np.random.RandomState(4)
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    k_loc, cap = K // RANKS, max(8, int(B // RANKS / RANKS * 2.0))
    path = {k: torch.from_numpy(v).to(dev)
            for k, v in q5_events(gen, rank_seqs(7, 0)).items()}
    whole = {k: torch.from_numpy(v).to(dev)
             for k, v in q5_batch(gen, 7).items()}

    def pids(n, p, lo=0, hi=None):
        return (torch.from_numpy(rng.randint(lo, p if hi is None else hi, n)
                                 .astype(np.int32)).to(dev),
                torch.from_numpy(rng.rand(n) < 0.7).to(dev), p)

    def events(n, n_dest, k, c, oob=False, skew=None):
        span = (-k * (n_dest + 2), k * (n_dest + 2)) if oob else (
            0, n_dest * k)
        key = rng.randint(*span, n)
        if skew is not None:
            hot = rng.randint(skew * k, (skew + 1) * k, n)
            key = np.where(rng.rand(n) < 0.6, hot, key)
        arrays = (rng.randint(0, 10_000, n).astype(np.int32),
                  key.astype(np.int32), rng.randn(n).astype(np.float32),
                  rng.rand(n) < 0.9)
        return [torch.from_numpy(a).to(dev) for a in arrays] + [n_dest, k, c]

    counts_cases = {
        "path_q5_dest": (torch.div(path["key"], k_loc, rounding_mode="floor"),
                         path["valid"], RANKS),
        "ref_512x128": pids(512, 128), "ref_2048x256": pids(2048, 256),
        "ref_4096x512": pids(4096, 512),
        "key_buckets_q5": (whole["key"], whole["valid"], K),
        "empty": pids(0, 5), "ragged": pids(1000, 7),
        "out_of_range": pids(5000, 33, -4, 40),
    }
    for name, (p_ids, valid, n_parts) in counts_cases.items():
        before = (route_counts.launches, route_offsets.launches)
        counts = route_counts(p_ids, valid, n_parts)
        c2, offsets = route_offsets(p_ids, valid, n_parts)
        torch.cuda.synchronize()
        n = p_ids.numel()
        if (route_counts.launches - before[0],
                route_offsets.launches - before[1]) != ((2, 1) if n
                                                        else (0, 0)):
            raise AssertionError(f"route {name}: launches off")
        want_c, want_o = route_offsets_plain(p_ids, valid, n_parts)
        if not (torch.equal(counts, route_counts_plain(p_ids, valid,
                                                       n_parts))
                and torch.equal(counts, want_c) and torch.equal(c2, want_c)
                and torch.equal(offsets, want_o)):
            raise AssertionError(f"route {name}: counts or offsets differ "
                                 f"from the plain version")
        log(f"route_counts/route_offsets {name}: N={n} P={n_parts} "
            f"max_abs_err=0 ok")

    pack_cases = {
        "path_q5": [path["ts"], path["key"], path["value"], path["valid"],
                    RANKS, k_loc, cap],
        "skew_overflow": events(B // RANKS, RANKS, k_loc, 2048, skew=3),
        "out_of_range": events(5000, 8, 8, 250, oob=True),
        "ragged": events(1025, 3, 5, 300),
        "most_destinations": events(5000, 32, 3, 20, oob=True),
        "empty": events(0, 4, 8, 8),
        "one_row": events(1, 4, 8, 8),
        "tile_less_one": events(1023, 2, 64, 600),
        "one_tile": events(1024, 1, 64, 2000, oob=True),
        "tile_and_one": events(1025, 2, 64, 600, skew=1),
        "path_rows_8_dest": events(16384, 8, 512, 4096, oob=True),
        "rows_2_20": events(2**20, 4, 4096, 2**16, skew=3),
        "c_1": events(3000, 4, 8, 1, oob=True),
        "c_1_most_destinations": events(3000, 32, 2, 1, skew=31),
    }
    for name, args in pack_cases.items():
        before = (route_counts.launches, route_offsets.launches,
                  route_pack.launches)
        got = route_pack(*args)
        torch.cuda.synchronize()
        n = args[0].numel()
        if (route_counts.launches, route_offsets.launches,
                route_pack.launches) != (before[0], before[1],
                                         before[2] + (1 if n else 0)):
            raise AssertionError(f"route_pack {name}: launches off")
        want = route_pack_plain(*args)
        if not (torch.equal(got.send, want.send)
                and torch.equal(got.pos, want.pos)
                and int(got.n_overflow) == int(want.n_overflow)):
            raise AssertionError(f"route_pack {name}: differs from the "
                                 f"plain version")
        # as the route plan calls it: no positions stored
        bare = route_pack(*args, with_pos=False)
        if not (bare.pos is None and torch.equal(bare.send, want.send)
                and int(bare.n_overflow) == int(want.n_overflow)):
            raise AssertionError(f"route_pack {name} without positions: "
                                 f"differs from the plain version")
        overflow = int(got.n_overflow)
        if name in ("skew_overflow", "rows_2_20", "c_1") and overflow == 0:
            raise AssertionError(f"{name}: no event overflowed C")
        log(f"route_pack {name}: N={n} n_dest={args[4]} k_loc={args[5]} "
            f"C={args[6]} overflow={overflow} max_abs_err=0 ok")
    # send, pos and n_overflow come from torch.empty: over memory that
    # held a non-zero pattern, every cell must still come out right
    args = pack_cases["skew_overflow"]
    want = route_pack_plain(*args)
    for _ in range(3):
        torch.full((RANKS, 4, 2048), -7, dtype=torch.int32, device=dev)
        torch.full((B // RANKS,), 123, dtype=torch.int32, device=dev)
        torch.full((), 99, dtype=torch.int32, device=dev)
        got = route_pack(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got.send, want.send)
                and torch.equal(got.pos, want.pos)
                and int(got.n_overflow) == int(want.n_overflow)):
            raise AssertionError("route_pack over poisoned memory differs "
                                 "from the plain version")
    log("route_pack over memory filled with -7, 123 and 99 first: equal to "
        "the plain version, every cell written")
    src = "src/repro_torch/kernels/csrc/route.cu"
    return [{"name": "route_counts", "route": "cuda", "source": src,
             "replaces": "src/repro/kernels/route.py:42",
             "max_abs_err": 0.0},
            {"name": "route_offsets", "route": "cuda", "source": src,
             "replaces": "src/repro/kernels/route.py:62",
             "max_abs_err": 0.0},
            {"name": "route_pack", "route": "cuda", "source": src,
             "replaces": "src/repro/streaming/executor.py:189",
             "max_abs_err": 0.0}]


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
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, results = ex.run_stream(feed, n_steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = accumulate_.launches
    others = {k: v for k, v in launch_counts().items() if k != "accumulate"}
    if any(others.values()):
        raise AssertionError(f"other kernels launched on the Q5 path: "
                             f"{others}")

    oracle = window_oracle(hist)
    n_windows = check_against_oracle(results, oracle, n_steps, exact=True)
    full = max(0, n_steps - SPEC.frames_per_window)
    drops = (int(state["dropped_late"]), int(state["dropped_conflict"]))
    if drops != (0, 0):
        raise AssertionError(f"dropped (late, conflict) = {drops}")
    if launches != n_steps:                 # one accumulate launch a step
        raise AssertionError(f"accumulate launched {launches} times in "
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
        "launches": launch_counts(),
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
def serve_prompts(cfg):
    rng = np.random.RandomState(0)
    return [(i, rng.randint(0, cfg.vocab_size, PROMPT_LEN).tolist())
            for i in range(N_REQUESTS)]


def serve_steps(server, pending, n: int) -> list:
    """``n`` server steps (fewer if the work drains), admitting pending
    requests first as serve.main does; host ms of each step, which ends in
    the step's one host read."""
    ms = []
    while len(ms) < n and (pending or server.active):
        while pending and server.submit(*pending[0], MAX_NEW):
            pending.pop(0)
        t0 = time.perf_counter()
        server.step()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def serve_path(dev, cfg, params):
    """The serve main path: 16 requests of 256 prompt and 256 new tokens
    over 8 slots, greedy decode through BatchedLMServer."""
    prompts = serve_prompts(cfg)
    # warm-up outside the count: cuBLAS handles, the allocator's pools
    warm = BatchedLMServer(cfg, params, batch_slots=SLOTS, max_seq=16,
                           device=dev)
    serve_steps(warm, [(0, prompts[0][1][:4])], 8)
    del warm
    server = BatchedLMServer(cfg, params, batch_slots=SLOTS,
                             max_seq=MAX_SEQ, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    step_ms = serve_steps(server, list(prompts), 10**6)
    dt = time.perf_counter() - t0
    launches = decode_attention.launches
    other = {k: v for k, v in launch_counts().items()
             if k != "decode_attention" and v}
    steps = len(step_ms)

    done = server.completed
    if sorted(r["id"] for r in done) != list(range(N_REQUESTS)):
        raise AssertionError(f"{len(done)} of {N_REQUESTS} requests done")
    if any(len(r["out"]) != MAX_NEW for r in done):
        raise AssertionError("a request ended with the wrong token count")
    toks = np.array([r["out"] for r in done])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"tokens outside [0, {cfg.vocab_size})")
    if server.pos - 1 >= MAX_SEQ:
        raise AssertionError(f"last pos {server.pos - 1} >= max_seq "
                             f"{MAX_SEQ}: the cache write clamped")
    if launches != cfg.n_layers * steps or other:
        raise AssertionError(f"decode_attention launched {launches} times "
                             f"in {steps} steps of {cfg.n_layers} layers "
                             f"(others {other})")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": sum(p.numel() for p in params.parameters()),
        "slots": SLOTS, "requests": N_REQUESTS, "prompt_len": PROMPT_LEN,
        "max_new": MAX_NEW, "max_seq": MAX_SEQ, "last_pos": server.pos - 1,
        "steps": steps, "wall_s": dt, "steps_per_s": steps / dt,
        "new_tokens_per_s": N_REQUESTS * MAX_NEW / dt,
        "fed_tokens_per_s": N_REQUESTS * (PROMPT_LEN + MAX_NEW - 1) / dt,
        "wall_ms_per_step": dt / steps * 1e3,
        "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_p99": float(np.percentile(step_ms, 99)),
        "host_reads_per_step": server.host_reads / steps,
        "weight_bytes": weight_bytes,
        "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_attention_launches": launches,
    }
    log(f"serve path: {N_REQUESTS} requests x {MAX_NEW} tokens, all tokens "
        f"in range, {launches} kernel launches = {cfg.n_layers} x {steps} "
        f"steps; {json.dumps(out)}")
    return out, server, step_ms


def tf32_step(dev, cfg, server) -> dict:
    """One full-depth decode step with TF32 switched on globally gives the
    logits it gives without (decode_step pins float32 matmuls to IEEE),
    and they are finite.  The control, the head's product outside the pin,
    must err beyond 1e-5 under TF32, or the phase proves nothing."""
    pos = server.pos

    def step():
        cache = [{k: t.clone() for k, t in c.items()} for c in server.cache]
        return transformer.decode_step(cfg, server.params, cache,
                                       server.tokens, pos, torch.float32)[0]

    h = torch.from_numpy(np.random.RandomState(2).randn(
        SLOTS, cfg.d_model).astype(np.float32)).to(dev)
    head = server.params.embed.T
    ieee, ctrl_ieee = step(), h @ head
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, ctrl_tf32 = step(), h @ head
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.isfinite(ieee).all():
        raise AssertionError("non-finite logits at full depth")
    torch.testing.assert_close(tf32, ieee, rtol=1e-6, atol=1e-6)
    ctrl = float((ctrl_tf32 - ctrl_ieee).abs().max()
                 / ctrl_ieee.abs().max())
    if not ctrl > 1e-5:
        raise AssertionError(f"TF32 control within 1e-5 ({ctrl:.3g}): the "
                             f"phase does not exercise TF32")
    res = {"pos": pos, "bitwise_equal": bool(torch.equal(tf32, ieee)),
           "max_abs_diff": float((tf32 - ieee).abs().max()),
           "tf32_control_rel_err": ctrl}
    log(f"serve step under TF32: logits finite and equal to IEEE; "
        f"{json.dumps(res)}")
    return res


# -- phase 8 -----------------------------------------------------------------
def card_vs_cpu(dev) -> dict:
    """qwen2-1.5b at full width cut to 4 layers, the same weights on card
    (the kernel) and CPU (plain versions), 16 teacher-forced steps of 8
    rows: logits within CPU_TOL, greedy tokens equal wherever the CPU's
    top-2 margin exceeds 1e-3."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=CPU_LAYERS)
    card = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                          torch.float32, device=dev)
    cpu = params_from_numpy(cfg, params_to_numpy(cfg, card), device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (CPU_STEPS, SLOTS)).astype(np.int32))
    caches = {d: lm.init_cache(cfg, SLOTS, CPU_STEPS, torch.float32,
                               device=d) for d in (dev, "cpu")}
    err, compared, agree = 0.0, 0, 0
    t0 = time.perf_counter()
    for pos in range(CPU_STEPS):
        lc = transformer.decode_step(cfg, card, caches[dev],
                                     tokens[pos].to(dev), pos,
                                     torch.float32)[0].cpu()
        lh = transformer.decode_step(cfg, cpu, caches["cpu"], tokens[pos],
                                     pos, torch.float32)[0]
        torch.testing.assert_close(lc, lh, **CPU_TOL)
        err = max(err, float((lc - lh).abs().max()))
        top2 = lh.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        compared += int(clear.sum())
        agree += int((lc.argmax(-1) == lh.argmax(-1))[clear].sum())
    if agree != compared:
        raise AssertionError(f"greedy tokens differ in {compared - agree} of "
                             f"{compared} clear-margin rows")
    res = {"layers": CPU_LAYERS, "steps": CPU_STEPS, "rows": SLOTS,
           "max_abs_logit_err": err, "clear_margin_rows": compared,
           "greedy_equal": agree, "s": time.perf_counter() - t0}
    log(f"card against CPU: logits within rtol=atol=1e-3; "
        f"{json.dumps(res)}")
    return res


# -- phase 9 -----------------------------------------------------------------
def rank_batches(rank: int, ranks: int, n_steps: int):
    """Rank ``rank``'s slice of every step's Q5 batch, generated ahead into
    pinned host memory (no rank makes another's events), and the per-frame
    bid histogram of the slice over all K buckets (the oracle's input)."""
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    b_loc = B // ranks
    cols = {"ts": torch.int32, "key": torch.int32, "value": torch.float32,
            "valid": torch.bool}
    bufs = {k: torch.empty((n_steps, b_loc), dtype=d, pin_memory=True)
            for k, d in cols.items()}
    hist = np.zeros((n_steps, K), np.int32)
    for i in range(n_steps):
        b = q5_events(gen, rank_seqs(i, rank, ranks))
        if not (b["ts"] // SLIDE_MS == i).all():
            raise AssertionError(f"step {i} spans more than frame {i}")
        for k in cols:
            bufs[k][i].numpy()[:] = b[k]
        hist[i] = np.bincount(b["key"][b["valid"]], minlength=K)
    return [{k: bufs[k][i] for k in cols} for i in range(n_steps)], hist


def rank_plan(ex, mesh, dev, feed, hist, n_steps: int) -> dict:
    """One plan's measured run on this rank, held against the oracle: this
    rank's columns of the global per-frame histograms (``psum_scatter`` of
    every rank's slice histograms, after the run)."""
    cfg = ex.cfg
    StreamExecutor(cfg, mesh=mesh, device=dev).run_stream(feed, 16)  # warm
    torch.cuda.synchronize()
    dist.barrier()
    zero_counts()
    t0 = time.perf_counter()
    state, results = ex.run_stream(feed, n_steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    staged = ex.transport.host_staged_bytes
    moved = ex.transport.collective_bytes
    mine = psum_scatter(ex.transport, torch.from_numpy(
        hist[:n_steps]).to(dev), dim=1).cpu().numpy()
    n_windows = check_against_oracle(results, window_oracle(mine), n_steps,
                                     exact=True)
    drops = (int(state["dropped_late"]), int(state["dropped_conflict"]))
    if drops != (0, 0):
        raise AssertionError(f"{cfg.exchange}: dropped (late, conflict) = "
                             f"{drops}")
    # exactly: one accumulate a step, one route_pack a route step (its
    # histogram is route_counts' device function inside it), and no
    # standalone route_counts or route_offsets
    want = {"window_agg": 0, "accumulate": n_steps, "decode_attention": 0,
            "route_counts": 0, "route_offsets": 0,
            "route_pack": n_steps if cfg.exchange == "route" else 0}
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{cfg.exchange}: {k} launched "
                                 f"{launches[k]} times in {n_steps} steps")
    return {"steps": n_steps, "windows_checked": n_windows,
            "owned_bids": int(mine.sum()),
            "steps_per_s": n_steps / dt, "wall_ms_per_step": dt / n_steps * 1e3,
            "host_staged_bytes": staged,
            "host_staged_mb_per_step": staged / n_steps / 1e6,
            "collective_mb_per_step": moved / n_steps / 1e6,
            "emit_rounds_per_step": ex.emit_rounds / n_steps,
            "host_syncs_per_step": ex.host_syncs / n_steps,
            "capacity": ex.capacity, "launches": launches}


def rank_profile(rank, mesh, dev, feed, n_steps: int, wall_ms: float):
    """Where a route step's time goes: rank 0 profiles a stretch (host ops
    and device kernels) while the other ranks run it alongside; against
    the measured run's wall time per step."""
    cfg = StreamJobConfig(window=SPEC, batch_size=B, exchange="route")

    def stretch():
        StreamExecutor(cfg, mesh=mesh, device=dev).run_stream(feed, n_steps)
        torch.cuda.synchronize()

    stretch()
    dist.barrier()
    if rank:
        stretch()
        return None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stretch()
        profiled_ms = (time.perf_counter() - t0) / n_steps * 1e3
    # device records (kernels, copies) alone: host ops carry their
    # kernels' device time too, and so do the collectives' "nccl:" and
    # "gloo:" annotations on the device's timeline; either would count it
    # twice
    events = prof.key_averages()
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("nccl:", "gloo:"))]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3 / n_steps
    kernels = sorted(((e.self_device_time_total / 1e3 / n_steps,
                       e.count / n_steps, e.key) for e in on_card
                      if e.self_device_time_total > 0), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3 / n_steps, e.count / n_steps,
                    e.key) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.self_cpu_time_total > 0), reverse=True)
    return {"steps": n_steps, "wall_ms_per_step": wall_ms,
            "profiled_wall_ms_per_step": profiled_ms,
            "device_ms_per_step": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "device_launches_per_step": sum(c for _, c, k in kernels),
            "top_device": [[k[:90], ms, c] for ms, c, k in kernels[:10]],
            "top_host_self": [[k[:90], ms, c] for ms, c, k in host[:12]]}


def q5_rank(rank: int, world: int, dev, route_steps: int, reduce_steps: int,
            profile_steps: int) -> dict:
    """One rank of phase 9 (run in its own process): the route plan, then
    the reduce plan, then the profiled route stretch."""
    mesh = make_data_mesh("cuda")
    t0 = time.perf_counter()
    batches, hist = rank_batches(rank, world, max(route_steps, reduce_steps))
    gen_s = time.perf_counter() - t0

    def feed(start, size):
        i = start // B
        if start != i * B + rank * (B // world) or size != B // world:
            raise AssertionError(f"rank {rank} asked for ({start}, {size})")
        return batches[i]

    out = {"rank": rank, "device": str(dev), "generate_s": gen_s}
    for exchange, n_steps in (("route", route_steps),
                              ("reduce", reduce_steps)):
        cfg = StreamJobConfig(window=SPEC, batch_size=B, exchange=exchange)
        ex = StreamExecutor(cfg, mesh=mesh, device=dev)
        out[exchange] = rank_plan(ex, mesh, dev, feed, hist, n_steps)
    # the route step with the fused accumulate against the plain one, in
    # turns and unprofiled, then each profiled (the profiler slows every
    # launch after it starts)
    cfg = StreamJobConfig(window=SPEC, batch_size=B, exchange="route")
    walls = {"fused": [], "plain": []}
    for which in ("plain", "fused", "fused", "plain"):
        with plain_accumulate() if which == "plain" else \
                contextlib.nullcontext():
            dist.barrier()
            t0 = time.perf_counter()
            StreamExecutor(cfg, mesh=mesh, device=dev).run_stream(
                feed, ROUTE_AB_STEPS)
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t0)
                                / ROUTE_AB_STEPS * 1e3)
    out["route_ab_wall_ms_per_step"] = walls
    out["profile"] = rank_profile(rank, mesh, dev, feed, profile_steps,
                                  min(walls["fused"]))
    with plain_accumulate():
        out["profile_plain_accumulate"] = rank_profile(
            rank, mesh, dev, feed, profile_steps, min(walls["plain"]))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def q5_ranks() -> dict:
    """Phase 9: Q5 across RANKS ranks, one spawned process a rank (this
    process already holds the card)."""
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= RANKS else "gloo"
    transport = (f"nccl, one card a rank" if backend == "nccl" else
                 f"gloo, {RANKS} ranks sharing {cards} card(s); "
                 f"all_to_all, all_reduce and reduce_scatter on CUDA "
                 f"tensors, ring moves staged through pinned host memory")
    log(f"Q5 across {RANKS} ranks: transport {transport}")
    t0 = time.perf_counter()
    per_rank = spawn_ranks(q5_rank, RANKS, backend=backend, device="cuda",
                           args=(ROUTE_STEPS, REDUCE_STEPS,
                                 RANK_PROFILE_STEPS), timeout_s=700)
    res = {"ranks": RANKS, "backend": backend, "transport": transport,
           "phase_s": time.perf_counter() - t0,
           "generate_s": [r["generate_s"] for r in per_rank],
           "peak_mem_gb": [r["peak_mem_gb"] for r in per_rank]}
    for plan in ("route", "reduce"):
        runs = [r[plan] for r in per_rank]
        launches = {k: sum(r["launches"][k] for r in runs)
                    for k in runs[0]["launches"]}
        slowest = max(runs, key=lambda r: r["wall_ms_per_step"])
        res[plan] = {
            "steps": runs[0]["steps"],
            "windows_checked_per_rank": runs[0]["windows_checked"],
            "owned_bids": [r["owned_bids"] for r in runs],
            "steps_per_s": [r["steps_per_s"] for r in runs],
            "wall_ms_per_step": [r["wall_ms_per_step"] for r in runs],
            "slowest_rank": runs.index(slowest),
            "slowest_steps_per_s": slowest["steps_per_s"],
            "slowest_wall_ms_per_step": slowest["wall_ms_per_step"],
            "events_per_s": B * slowest["steps_per_s"],
            "host_staged_bytes": [r["host_staged_bytes"] for r in runs],
            "host_staged_mb_per_step": [r["host_staged_mb_per_step"]
                                        for r in runs],
            "collective_mb_per_step": [r["collective_mb_per_step"]
                                       for r in runs],
            "emit_rounds_per_step": runs[0]["emit_rounds_per_step"],
            "host_syncs_per_step": runs[0]["host_syncs_per_step"],
            "capacity": runs[0]["capacity"],
            "launches": launches,
            "launches_per_rank": [r["launches"] for r in runs]}
        log(f"Q5 across ranks, {plan} plan: every rank's columns equal the "
            f"numpy oracle exactly, drops 0; {json.dumps(res[plan])}")
    res["profile"] = per_rank[0]["profile"]
    res["profile_plain_accumulate"] = per_rank[0]["profile_plain_accumulate"]
    res["route_ab_wall_ms_per_step"] = [r["route_ab_wall_ms_per_step"]
                                        for r in per_rank]
    plain = res["profile_plain_accumulate"]
    log(f"route step on rank 0 with the plain accumulate: wall "
        f"{plain['wall_ms_per_step']:.4f} ms, device "
        f"{plain['device_ms_per_step']:.4f} ms, idle share "
        f"{plain['device_idle_share']:.4f}, "
        f"{plain['device_launches_per_step']:.2f} device launches a step; "
        f"walls a step in turns (plain, fused, fused, plain) on every rank: "
        f"{json.dumps(res['route_ab_wall_ms_per_step'])}")
    prof = res["profile"]
    log(f"route plan per step on rank 0: wall {prof['wall_ms_per_step']:.4f}"
        f" ms, device {prof['device_ms_per_step']:.4f} ms, idle share "
        f"{prof['device_idle_share']:.4f}, "
        f"{prof['device_launches_per_step']:.2f} device launches a step; "
        f"top device time:")
    for name, ms, c in prof["top_device"]:
        log(f"  {ms:.5f} ms  x{c:.2f}  {name}")
    log("  top host self time:")
    for name, ms, c in prof["top_host_self"]:
        log(f"  {ms:.5f} ms  x{c:.2f}  {name}")
    return res


# -- phase 10 ----------------------------------------------------------------
#: (a): test_device_window.py's _run_q5 stream
EQUIV_RATE, EQUIV_EVENTS = 60_000, 12_000
EQUIV_DEVICE = dict(n_key_buckets=64, batch_size=256)
#: (b): PERF.md §4's Q5 through the engine, paced on the wall clock
ENGINE_RATE = 100_000            # events/s: 1 000 a 10 ms frame
#: 1 500 frames, 500 full windows.  Every 10 ms slide closes a window over
#: nearly all 10 000 auctions, and the end of the stream closes 999 more:
#: 24.8 M results, converted on the host at about 3 µs each (PERF.md §5)
ENGINE_EVENT_S = 15.0
ENGINE_BATCH = 16_384
ENGINE_WARMUP_S = 1.0            # bench_latency.host_q5_latency's cut
ENGINE_DEADLINE_S = 300.0


def device_procs(job) -> list:
    return [t.processor for t in job.execution.tasklets
            if isinstance(t.processor, DeviceWindowProcessor)]


def engine_q5(dev, placement: str, n_nodes: int = 1,
              exactly_once: bool = False, kill_at_result=None):
    """Q5 through the port's ``JetCluster`` on a virtual clock, as
    ``tests/test_device_window.py::_run_q5`` runs the reference: the sorted
    set of ``(ts, key, window_end, value)``, the late drops, and the
    device processors of the last execution."""
    gen = NexmarkGenerator(rate=EQUIV_RATE, n_keys=40)
    cluster = JetCluster(n_nodes=n_nodes, cooperative_threads=2,
                         clock=VirtualClock(auto_step=0.001))
    out = []
    p = queries.q5(
        lambda: PacedGeneratorSource(gen, rate=EQUIV_RATE,
                                     max_events=EQUIV_EVENTS),
        lambda: CollectorSink(out), window_ms=100, slide_ms=20,
        placement=placement, device=dict(EQUIV_DEVICE, device=dev))
    job = cluster.submit(p.to_dag(), JobConfig(
        processing_guarantee=GUARANTEE_EXACTLY_ONCE if exactly_once
        else GUARANTEE_NONE, snapshot_interval_s=0.02))
    killed = False
    for _ in range(4_000_000):
        if job.status == JOB_COMPLETED:
            break
        cluster.step()
        if (kill_at_result is not None and not killed
                and len(out) >= kill_at_result and job.snapshots_taken > 0):
            cluster.kill_node(cluster.node_ids[-1])
            killed = True
    if job.status != JOB_COMPLETED:
        raise AssertionError(f"{placement} Q5 job ended {job.status}")
    if kill_at_result is not None and not killed:
        raise AssertionError("the node was never killed")
    drops = sum(getattr(t.processor, "late_dropped", 0)
                for t in job.execution.tasklets)
    return (sorted(set((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                       for ev in out)), drops, device_procs(job))


def engine_equivalence(dev) -> dict:
    """(a): device placement on the card against host placement, and the
    exactly-once restore through a node kill."""
    host, host_drops, _ = engine_q5(dev, "host")
    zero_counts()
    got, drops, procs = engine_q5(dev, "device")
    launches = launch_counts()
    if not procs or any(p.executor.device.type != "cuda" for p in procs):
        raise AssertionError("the device vertex did not run on the card")
    if got != host or not got:
        raise AssertionError(f"device placement gave {len(got)} results, "
                             f"host placement {len(host)}; they differ")
    if drops or host_drops:
        raise AssertionError(f"late drops: device {drops}, host {host_drops}")
    steps = sum(p._steps for p in procs) + len(procs)   # + the warm-ups
    if launches["accumulate"] != steps or launches["window_agg"]:
        raise AssertionError(f"{launches} in {steps} device steps")
    base, _, _ = engine_q5(dev, "device", n_nodes=2)
    killed, _, procs = engine_q5(dev, "device", n_nodes=2,
                                 exactly_once=True, kill_at_result=30)
    if killed != base or base != host:
        raise AssertionError("the run through kill_node differs from the "
                             "run without a failure")
    if not procs or any(p.executor.device.type != "cuda" for p in procs):
        raise AssertionError("the restored device vertex is not on the card")
    res = {"results": len(got), "device_steps": steps,
           "accumulate_launches": launches["accumulate"],
           "kill_node_results": len(killed)}
    log(f"engine (a): device placement on the card equals host placement "
        f"({len(got)} results, no late drops); through kill_node equal to "
        f"the run without a failure; {json.dumps(res)}")
    return res


def engine_oracle(gen, total: int) -> np.ndarray:
    """Every window's bid count per auction from the generator's sequence
    numbers alone: row L is the window ending at (L + 1) * slide, up to
    the last window the end of the stream closes."""
    F = SPEC.frames_per_window
    blk = gen.gen_block(np.arange(total))
    bid = blk.cols["kind"] == 2
    frames = (blk.ts[bid] // SLIDE_MS).astype(np.int64)
    n_frames = int(frames.max()) + 1
    hist = np.zeros((n_frames + F - 1, N_AUCTIONS), np.int64)
    np.add.at(hist, (frames, blk.key[bid]), 1)
    return window_oracle(hist)


class ResultColumns(Processor):
    """Phase 10's sink: each result's window, auction and value appended
    to columns, and one clock read for each batch the tasklet hands it
    (its results arrive together)."""

    def __init__(self, clock, cols: dict):
        self.clock, self.cols = clock, cols

    def process(self, ordinal, inbox) -> None:
        cols = self.cols
        put_ts, put_key = cols["ts"].append, cols["key"].append
        put_value = cols["value"].append
        n = 0
        for ev in inbox:
            put_ts(ev.ts)
            put_key(ev.key)
            put_value(ev.value.value)
            n += 1
        inbox.clear()
        cols["now"].append(self.clock.now())
        cols["count"].append(n)


def percentiles_ms(lat_s: np.ndarray) -> dict:
    """p50 / p99 / p99.99 of latencies in seconds, in ms; a p99.99 needs
    10 000 samples (bench_latency.P9999_MIN_SAMPLES)."""
    p50, p99, p9999 = np.percentile(lat_s, [50, 99, 99.99]) * 1e3
    return {"samples": int(lat_s.size), "p50_ms": p50, "p99_ms": p99,
            "p99.99_ms": p9999 if lat_s.size >= 10_000 else None,
            "max_ms": float(lat_s.max()) * 1e3}


def engine_paced(dev, event_s: float = ENGINE_EVENT_S) -> dict:
    """(b): Q5 at the paper's shape through the engine on the wall clock,
    paced at ``ENGINE_RATE``.  Latency as bench_latency.host_q5_latency
    takes it: the ideal time of a result is ``t0 + (ts + 1) / 1000``
    (``ts`` is its window end - 1), results before ``t0 + warm-up`` and
    those the end of the stream flushes early are cut."""
    total = int(ENGINE_RATE * event_s)
    gen = NexmarkGenerator(rate=ENGINE_RATE, n_keys=N_AUCTIONS)
    t0 = time.perf_counter()
    oracle = engine_oracle(gen, total)
    log(f"engine (b): oracle of {oracle.shape[0]} windows x {N_AUCTIONS} "
        f"auctions from {total} events in {time.perf_counter() - t0:.1f} s")
    clock = WallClock()
    cluster = JetCluster(n_nodes=1, cooperative_threads=1, clock=clock)
    cols = {"ts": array.array("q"), "key": array.array("q"),
            "value": array.array("d"), "now": array.array("d"),
            "count": array.array("q")}
    p = queries.q5(
        lambda: PacedGeneratorSource(gen, rate=ENGINE_RATE, max_events=total),
        lambda: ResultColumns(clock, cols), window_ms=WINDOW_MS,
        slide_ms=SLIDE_MS,
        placement="device",
        device=dict(n_key_buckets=K, batch_size=ENGINE_BATCH, device=dev))
    zero_counts()
    job = cluster.submit(p.to_dag(), JobConfig())    # warm-up step in init
    procs = device_procs(job)
    if len(procs) != 1 or procs[0].executor.device.type != "cuda":
        raise AssertionError("expected one device vertex on the card")
    proc = procs[0]
    # instrumentation: CUDA events and the host clock around every device
    # step, the host clock around every conversion of a step's results
    marks, host_s = [], {"step": 0.0, "convert": 0.0}
    step, convert = proc.executor.step, proc._convert

    def timed_step(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        r = step(*args, **kw)
        e1.record()
        host_s["step"] += time.perf_counter() - t
        marks.append((e0, e1))
        return r

    def timed_convert(out):
        t = time.perf_counter()
        convert(out)
        host_s["convert"] += time.perf_counter() - t

    proc.executor.step, proc._convert = timed_step, timed_convert
    t0 = clock.now()
    deadline = time.monotonic() + ENGINE_DEADLINE_S
    while job.status != JOB_COMPLETED:
        if time.monotonic() > deadline:
            raise AssertionError(f"the paced Q5 job did not complete in "
                                 f"{ENGINE_DEADLINE_S} s")
        cluster.step()
    t_done = clock.now()
    torch.cuda.synchronize()
    launches = launch_counts()

    ts, key = (np.frombuffer(cols[k], np.int64) for k in ("ts", "key"))
    value = np.frombuffer(cols["value"], np.float64)
    at = np.repeat(np.frombuffer(cols["now"], np.float64),
                   np.frombuffer(cols["count"], np.int64))
    rows = (ts + 1) // SLIDE_MS - 1
    if rows.min() < 0 or rows.max() >= oracle.shape[0] or \
            key.min() < 0 or key.max() >= N_AUCTIONS:
        raise AssertionError("a result outside the oracle's windows")
    flat = rows * N_AUCTIONS + key
    if np.unique(flat).size != flat.size:
        raise AssertionError("a (window_end, auction) emitted twice")
    got = np.zeros(oracle.size, np.int64)
    got[flat] = value.astype(np.int64)
    if not np.array_equal(got, oracle.ravel()) or \
            not np.array_equal(value, got[flat]):
        bad = np.flatnonzero(got != oracle.ravel())
        raise AssertionError(f"{bad.size} (window, auction) counts differ "
                             f"from the oracle, e.g. {bad[:5]}")
    counters = {"late_dropped": proc.late_dropped,
                "conflict_dropped": proc.conflict_dropped,
                "bucket_collisions": proc.bucket_collisions}
    if any(counters.values()):
        raise AssertionError(f"drops or collisions: {counters}")
    steps = proc._steps + 1                         # + the warm-up
    others = {k: v for k, v in launches.items() if k != "accumulate"}
    if launches["accumulate"] != steps or any(others.values()):
        raise AssertionError(f"{launches} in {steps} device steps")

    ideal = t0 + (ts + 1) / 1000.0
    end = t0 + total / ENGINE_RATE
    kept = (at >= t0 + ENGINE_WARMUP_S) & (ideal <= end)
    lat = percentiles_ms(at[kept] - ideal[kept])
    # the stream's input is processed once the last window that closes
    # inside it reaches the sink
    last_end = int(ts[ideal <= end].max()) + 1
    t_in = float(at[ts + 1 == last_end].max())
    lag_s = t_in - (t0 + last_end / 1000.0)
    ends = (np.unique(rows) + 1) * SLIDE_MS
    dev_ms = [a.elapsed_time(b) for a, b in marks]
    stats = job.execution.stats()
    res = {
        "event_s": event_s, "offered_events_per_s": ENGINE_RATE,
        "events": total, "results": int(ts.size),
        "windows": int(ends.size),
        "full_windows": int(np.sum((ends >= WINDOW_MS) & (ends <= last_end))),
        "wall_s": t_done - t0, "input_wall_s": t_in - t0,
        "input_events_per_s": total / (t_in - t0),
        "results_per_s": ts.size / (t_done - t0),
        "results_per_s_in_stream": int(np.sum(at <= t_in)) / (t_in - t0),
        "kept_pace": bool(lag_s <= 1.0), "end_of_stream_lag_s": lag_s,
        "latency": lat,
        "vertex_time_share": cluster.vertex_time_share(),
        "device_steps": steps,
        "accumulate_launches": launches["accumulate"],
        "step_device_ms_mean": float(np.mean(dev_ms)),
        "step_device_ms_p50_p99": np.percentile(dev_ms, [50, 99]).tolist(),
        "step_host_ms_mean": host_s["step"] / len(marks) * 1e3,
        "convert_host_s": host_s["convert"],
        "convert_us_per_result": host_s["convert"] / ts.size * 1e6,
        "engine": {k: stats[k] for k in ("items_in", "items_out", "calls",
                                          "idle_calls")},
        **counters,
    }
    log(f"engine (b): {res['windows']} windows x auctions equal the numpy "
        f"oracle exactly ({ts.size} results); drops and collisions 0; "
        f"{steps} device steps, one accumulate each")
    log(f"engine (b): input {res['input_events_per_s']:.1f} events/s "
        f"(offered {ENGINE_RATE}), results {res['results_per_s']:.1f}/s, "
        f"kept pace: {res['kept_pace']} (end of stream "
        f"{lag_s:.3f} s late)")
    log(f"engine (b): latency p50 {lat['p50_ms']} ms, p99 {lat['p99_ms']} "
        f"ms, p99.99 {lat['p99.99_ms']} ms over {lat['samples']} results")
    log(f"engine (b): vertex time share "
        f"{json.dumps(res['vertex_time_share'])}")
    log(f"engine (b): {json.dumps(res)}")
    return res


def engine_path(dev) -> dict:
    """Phase 10: (a), then (b)."""
    return {"equivalence": engine_equivalence(dev),
            "paced": engine_paced(dev)}


# -- phase 12 ----------------------------------------------------------------
#: (a): the reference chaos tests' seeds over phase 10 (a)'s stream; the
#: kinds the in-process backend can express and the three corruptions
FAULT_SEEDS = (1, 2, 3)
FAULT_KINDS = (KIND_KILL, KIND_RAISE) + CORRUPTION_KINDS
FAULT_SNAPSHOT_VIRTUAL_S = 0.02      # phase 10 (a)'s interval
#: (b): phase 10 (b)'s configuration, event time cut from 15 s to 3 s (the
#: close-out of ~999 windows x ~10 000 auctions is there whatever the cut)
FAULT_EVENT_S = 3.0
FAULT_SNAPSHOT_S = 1.0
FAULT_B_SEED = 1
FAULT_DEADLINE_S = 300.0
#: (c): the multiprocess backend, 2 nodes x 2 cooperative threads = 4
#: worker processes, in a subprocess that cannot see the card
MP_NODES, MP_THREADS = 2, 2
#: tests/test_chaos.py's stream (40 auctions, window 100 / slide 20); the
#: SIGKILL lands after the first committed snapshot, as there
MP_REF = dict(rate=60_000, n_keys=40, events=48_000, window_ms=100,
              slide_ms=20, snapshot_s=0.1, after_snapshot=True)
#: (b)'s stream cut to its first 10 ms frame: the host plan ships every
#: result of the close-out (~999 windows x ~880 auctions) through the
#: pipes.  The close-out runs inside the windows' completion, so no
#: barrier aligns before it ends: the SIGKILL lands mid close-out with no
#: snapshot committed, and the job heals by replaying from the start.  A
#: worker's close-out slices can outlast the supervisor's default 5 s
#: heartbeat deadline (on a loaded 8-core host a replay read one as hung),
#: so this stream's workers get 30 s
MP_PAPER = dict(rate=ENGINE_RATE, n_keys=N_AUCTIONS, events=1_000,
                window_ms=WINDOW_MS, slide_ms=SLIDE_MS, snapshot_s=0.2,
                after_snapshot=False, heartbeat_timeout_s=30.0)
MP_SEED = 1
MP_RUN_DEADLINE_S = 180.0
MP_TIMEOUT_S = 600


class DeviceSteps:
    """Every ``DeviceWindowProcessor`` a run built, across restarts and
    cold starts, held so its device steps can be counted after its
    execution was torn down: each made one warm-up step in ``init`` and
    ``_steps`` since."""

    def __init__(self):
        self.procs: dict = {}

    def see(self, job) -> None:
        if job.execution is not None:
            for p in device_procs(job):
                self.procs[id(p)] = p

    def steps(self) -> int:
        return sum(p._steps + 1 for p in self.procs.values())

    def check(self, launches: dict, what: str) -> int:
        """One ``accumulate`` launch a device step, nothing else, every
        processor on the card; returns the steps."""
        steps = self.steps()
        if any(p.executor.device.type != "cuda"
               for p in self.procs.values()):
            raise AssertionError(f"{what}: a device vertex off the card")
        others = {k: v for k, v in launches.items() if k != "accumulate"}
        if launches["accumulate"] != steps or any(others.values()):
            raise AssertionError(f"{what}: {launches} in {steps} device "
                                 f"steps")
        return steps


def drive_job(cluster, job, tracker, tick=None, until=None,
              deadline_s: float = FAULT_DEADLINE_S) -> None:
    """Step ``cluster`` until ``job`` completes (or ``until()``), ticking
    the chaos controller after every step."""
    tracker.see(job)
    deadline = time.monotonic() + deadline_s
    while job.status not in (JOB_COMPLETED, JOB_FAILED):
        if until is not None and until():
            return
        if time.monotonic() > deadline:
            raise AssertionError(f"job stuck in {job.status}: "
                                 f"{job.recovery_diagnostics()}")
        cluster.step()
        tracker.see(job)
        if tick is not None:
            tick()
    if until is not None:
        raise AssertionError("the job ended before the phase's condition")
    if job.status != JOB_COMPLETED:
        raise AssertionError(f"job {job.status}: "
                             f"{job.recovery_diagnostics()}")


def fault_config() -> JobConfig:
    return JobConfig(processing_guarantee=GUARANTEE_EXACTLY_ONCE,
                     snapshot_interval_s=FAULT_SNAPSHOT_VIRTUAL_S,
                     restart_policy=RestartPolicy(max_restarts=8))


def reference_q5(dev, sink):
    """Phase 10 (a)'s Q5 with device placement on ``dev``, writing to
    ``sink`` (a supplier)."""
    gen = NexmarkGenerator(rate=EQUIV_RATE, n_keys=40)
    return queries.q5(
        lambda: PacedGeneratorSource(gen, rate=EQUIV_RATE,
                                     max_events=EQUIV_EVENTS),
        sink, window_ms=100, slide_ms=20, placement="device",
        device=dict(EQUIV_DEVICE, device=dev))


def delivered_once(collector, job) -> set:
    """The transactional sink's committed output as ``(window_end, key,
    value)``.  Every result is released once; the one exception the
    protocol allows is a restore that fell back past a corrupted chain
    head: epochs the head had released are released again after it (the
    external system cannot unsee them), and each such result then carries
    the same value in an epoch at or below the skipped head and in one
    above it."""
    epochs: dict = {}
    for txn, wr in collector.committed:
        epoch = txn[0] if isinstance(txn[0], int) else float("inf")
        epochs.setdefault((wr.window_end, wr.key), []).append(
            (epoch, wr.value))
    skipped = [s["snapshot_id"] for r in job.recovery_log
               for s in r["skipped"]]
    for key, seen in epochs.items():
        if len({v for _e, v in seen}) != 1:
            raise AssertionError(f"{key} delivered with values {seen}")
        if len(seen) > 1 and not (
                skipped and len(seen) == 2
                and seen[0][0] <= max(skipped) < seen[1][0]):
            raise AssertionError(f"{key} delivered {len(seen)} times in "
                                 f"epochs {[e for e, _v in seen]}")
    return {(w, k, seen[0][1]) for (w, k), seen in epochs.items()}


def reference_fault_run(dev, snap_dir: Path, kind: str, seed=None) -> dict:
    """One durable exactly-once run of ``reference_q5`` on 2 nodes on a
    virtual clock, its output through a transactional (``kind="tx"``) or
    an idempotent sink into an ``ExternalCollector``; with a seed, a
    ``ChaosSchedule.from_seed`` of ``FAULT_KINDS`` through the controller,
    whose logical clock is what the sink has delivered."""
    collector = ExternalCollector()
    if kind == "tx":
        sink = lambda: TransactionalSink(collector)            # noqa: E731
        clock_of = collector.committed
    else:
        sink = lambda: IdempotentSink(                         # noqa: E731
            collector, key_fn=lambda ev: (ev.value.window_end, ev.key))
        clock_of = collector.kv
    cluster = JetCluster(n_nodes=2, cooperative_threads=2,
                         clock=VirtualClock(auto_step=0.001),
                         snapshot_dir=snap_dir)
    tracker = DeviceSteps()
    ctl = None
    zero_counts()
    try:
        job = cluster.submit(reference_q5(dev, sink).to_dag(),
                             fault_config())
        if seed is not None:
            schedule = ChaosSchedule.from_seed(
                seed, n_faults=len(FAULT_KINDS), total_results=560,
                kinds=FAULT_KINDS)
            ctl = ChaosController(cluster, job, clock_of, schedule)
        drive_job(cluster, job, tracker,
                  tick=None if ctl is None else ctl.tick)
    finally:
        cluster.shutdown()
    launches = launch_counts()
    steps = tracker.check(launches, f"(a) seed {seed} {kind}")
    if kind == "tx":
        results = delivered_once(collector, job)
    else:
        results = {(w, k, wr.value) for (w, k), wr in collector.kv.items()}
    return {
        "results": results, "steps": steps,
        "accumulate_launches": launches["accumulate"],
        "restarts": job.auto_restarts, "snapshots": job.snapshots_taken,
        "fallbacks": [(r["restored_snapshot"],
                       [s["snapshot_id"] for s in r["skipped"]])
                      for r in job.recovery_log if r["skipped"]],
        "faults": [] if ctl is None else [
            {"kind": f.kind, "at": f.at_result, "fired": f.fired,
             "skipped": f.skipped, "fired_at_result": f.fired_at_result,
             **({"snapshot": f.params["snapshot_id"]}
                if "snapshot_id" in f.params else {})}
            for f in ctl.schedule.faults],
    }


def reference_cold_start(dev, snap_dir: Path) -> dict:
    """The coordinator dies mid-run (its cluster shut down with the job
    running); a fresh cluster cold-starts the job from the durable chain
    (``recover_job``) onto the card.  The collector is the external
    system: it outlives both."""
    collector = ExternalCollector()
    sink = lambda: TransactionalSink(collector)                # noqa: E731
    tracker = DeviceSteps()
    zero_counts()
    cluster = JetCluster(n_nodes=2, cooperative_threads=2,
                         clock=VirtualClock(auto_step=0.001),
                         snapshot_dir=snap_dir)
    try:
        job = cluster.submit(reference_q5(dev, sink).to_dag(),
                             fault_config())
        drive_job(cluster, job, tracker,
                  until=lambda: job.snapshots_taken >= 2
                  and len(collector.committed) >= 150)
        before = len(collector.committed)
    finally:
        cluster.shutdown()
    cluster = JetCluster(n_nodes=2, cooperative_threads=2,
                         clock=VirtualClock(auto_step=0.001),
                         snapshot_dir=snap_dir)
    try:
        job2 = cluster.recover_job(reference_q5(dev, sink).to_dag())
        cold = job2.recovery_log[0]
        if cold["event"] != "cold_start" or not cold["entries"]:
            raise AssertionError(f"the cold start restored nothing: {cold}")
        drive_job(cluster, job2, tracker)
    finally:
        cluster.shutdown()
    launches = launch_counts()
    steps = tracker.check(launches, "(a) cold start")
    return {"results": delivered_once(collector, job2), "steps": steps,
            "accumulate_launches": launches["accumulate"],
            "committed_before_death": before,
            "restored_snapshot": cold["restored_snapshot"],
            "restored_entries": cold["entries"], "chain": cold["chain"]}


def faults_reference_stream(dev) -> dict:
    """(a): phase 10 (a)'s stream through seeded faults on the card."""
    t0 = time.perf_counter()
    host, _, _ = engine_q5(dev, "host")
    host = {(w, k, v) for _t, k, w, v in host}
    res: dict = {"seeds": {}}
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        clean = reference_fault_run(dev, Path(tmp) / "clean", "tx")
        if clean["results"] != host or not host:
            raise AssertionError(f"device placement delivered "
                                 f"{len(clean['results'])} results, host "
                                 f"placement {len(host)}; they differ")
        launches += clean["accumulate_launches"]
        for seed in FAULT_SEEDS:
            for kind in ("tx", "idempotent"):
                run = reference_fault_run(
                    dev, Path(tmp) / f"s{seed}{kind}", kind, seed)
                if run["results"] != host:
                    raise AssertionError(
                        f"seed {seed} ({kind} sink): {len(run['results'])} "
                        f"results differ from the clean run's {len(host)}")
                if run["restarts"] < 1:
                    raise AssertionError(f"seed {seed} ({kind}): no fault "
                                         f"healed: {run['faults']}")
                launches += run["accumulate_launches"]
                run.pop("results")
                res["seeds"][f"{seed}/{kind}"] = run
                log(f"faults (a): seed {seed}, {kind} sink: equal to the "
                    f"clean run and to host placement ({len(host)} "
                    f"results); {json.dumps(run)}")
        cold = reference_cold_start(dev, Path(tmp) / "cold")
        if cold["results"] != host:
            raise AssertionError(f"the cold start delivered "
                                 f"{len(cold['results'])} results, the clean "
                                 f"run {len(host)}")
        launches += cold["accumulate_launches"]
        cold.pop("results")
        res["cold_start"] = cold
        log(f"faults (a): cold start from the chain onto the card: every "
            f"result delivered once, equal to the clean run; "
            f"{json.dumps(cold)}")
    res["results"] = len(host)
    res["accumulate_launches"] = launches
    res["wall_s"] = time.perf_counter() - t0
    log(f"faults (a): {res['wall_s']:.1f} s")
    return res


@contextlib.contextmanager
def snapshot_probes(dev):
    """Within the block, time every snapshot's build on the device vertex
    (``_build_snapshot_entries``: the clone, the copy to the host,
    ``np.nonzero`` and the Python loop), its spill to disk (the durable
    store's ``commit``, with the bytes it wrote), every restore's load
    from the chain (``Job._select_restore_snapshot``: verify and read)
    and its rebuild onto the card (``ExecutionContext.
    restore_from_snapshot``, synchronised)."""
    rec = {"builds": [], "spills": [], "loads": [], "restores": []}
    build = DeviceWindowProcessor._build_snapshot_entries
    commit = DurableSnapshotStore.commit
    select = Job._select_restore_snapshot
    restore = ExecutionContext.restore_from_snapshot

    def timed_build(self):
        t = time.perf_counter()
        entries = build(self)
        rec["builds"].append({
            "s": time.perf_counter() - t,
            "snapshot": getattr(self, "current_snapshot_id", None),
            "entries": len(entries),
            "pairs": sum(len(v) for k, v in entries if k[0] == "k")})
        return entries

    def timed_commit(self, job_id, snapshot_id):
        t = time.perf_counter()
        commit(self, job_id, snapshot_id)
        d = self.snapshot_dir(job_id, snapshot_id)
        rec["spills"].append({
            "s": time.perf_counter() - t, "snapshot": snapshot_id,
            "bytes": sum(f.stat().st_size for f in d.iterdir())})

    def timed_select(self):
        t = time.perf_counter()
        got = select(self)
        rec["loads"].append({"s": time.perf_counter() - t,
                             "snapshot": got[0]})
        return got

    def timed_restore(self, snapshot_id):
        t = time.perf_counter()
        n = restore(self, snapshot_id)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec["restores"].append({"s": time.perf_counter() - t,
                                "snapshot": snapshot_id, "entries": n})
        return n

    DeviceWindowProcessor._build_snapshot_entries = timed_build
    DurableSnapshotStore.commit = timed_commit
    Job._select_restore_snapshot = timed_select
    ExecutionContext.restore_from_snapshot = timed_restore
    try:
        yield rec
    finally:
        DeviceWindowProcessor._build_snapshot_entries = build
        DurableSnapshotStore.commit = commit
        Job._select_restore_snapshot = select
        ExecutionContext.restore_from_snapshot = restore


def paper_q5(dev, gen, total: int, cols: dict, clock):
    return queries.q5(
        lambda: PacedGeneratorSource(gen, rate=ENGINE_RATE, max_events=total),
        lambda: ResultColumns(clock, cols), window_ms=WINDOW_MS,
        slide_ms=SLIDE_MS, placement="device",
        device=dict(n_key_buckets=K, batch_size=ENGINE_BATCH, device=dev))


def recovery_gap(flat: np.ndarray, at: np.ndarray, n0: int, t0: float):
    """From a fault at wall time ``t0`` with ``n0`` results in the sink:
    the seconds to the first result after it, to the first result not
    delivered before it, and the results replayed in between."""
    if flat.size <= n0:
        raise AssertionError("no result after the fault")
    seen = np.isin(flat[n0:], np.unique(flat[:n0]))
    new = int(np.argmin(seen)) if not seen.all() else None
    return {"results_at_fault": n0,
            "to_first_result_s": float(at[n0] - t0),
            "to_first_new_result_s": None if new is None
            else float(at[n0 + new] - t0),
            "replayed": int(seen.sum()) if new is None else new}


def faults_paper_shape(dev, event_s: float = FAULT_EVENT_S) -> dict:
    """(b): phase 10 (b)'s configuration through a seeded kill after the
    first committed snapshot, a flipped byte in the chain head, then the
    coordinator's death and a cold start on a fresh cluster, which must
    fall back past the corrupted head.  Every (window, auction) count
    equals ``engine_oracle``'s, with no drops."""
    total = int(ENGINE_RATE * event_s)
    gen = NexmarkGenerator(rate=ENGINE_RATE, n_keys=N_AUCTIONS)
    t_phase = time.perf_counter()
    oracle = engine_oracle(gen, total)
    # results of the windows that close inside the stream (the rest are
    # the close-out's)
    last_frame = (total - 1) * 1000 // ENGINE_RATE // SLIDE_MS
    in_stream = int(np.count_nonzero(oracle[:last_frame]))
    schedule = ChaosSchedule.from_seed(
        FAULT_B_SEED, n_faults=1, total_results=in_stream,
        kinds=(KIND_KILL,), lo_frac=0.1, hi_frac=0.3)
    schedule.faults.append(Fault(KIND_CORRUPT_FLIP,
                                 at_result=int(0.8 * in_stream)))
    log(f"faults (b): {total} events ({event_s} s of event time, cut from "
        f"{ENGINE_EVENT_S} s), {int(np.count_nonzero(oracle))} results, "
        f"{in_stream} of them in the stream; faults {schedule.faults}")
    cols = {"ts": array.array("q"), "key": array.array("q"),
            "value": array.array("d"), "now": array.array("d"),
            "count": array.array("q")}
    tracker = DeviceSteps()
    res: dict = {"event_s": event_s, "cut_from_event_s": ENGINE_EVENT_S,
                 "events": total, "snapshot_interval_s": FAULT_SNAPSHOT_S}
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp, \
            snapshot_probes(dev) as rec:
        snap_dir = Path(tmp) / "chain"
        clock = WallClock()
        cluster = JetCluster(n_nodes=1, cooperative_threads=1, clock=clock,
                             snapshot_dir=snap_dir)
        try:
            job = cluster.submit(
                paper_q5(dev, gen, total, cols, clock).to_dag(),
                JobConfig(processing_guarantee=GUARANTEE_EXACTLY_ONCE,
                          snapshot_interval_s=FAULT_SNAPSHOT_S,
                          restart_policy=RestartPolicy(max_restarts=4)))
            ctl = ChaosController(cluster, job, cols["ts"], schedule)
            drive_job(cluster, job, tracker, tick=ctl.tick,
                      until=lambda: schedule.done)
            chain = cluster.snapshot_store.recovery_chain(job.id)
            t_death = time.monotonic()
            n_death = len(cols["ts"])
            first = {"restarts": job.auto_restarts,
                     "snapshots": job.snapshots_taken,
                     "recovery_log": job.recovery_log, "chain": chain}
        finally:
            cluster.shutdown()           # the coordinator dies here
        kill, corrupt = schedule.faults
        if not (kill.fired and corrupt.fired) or first["restarts"] < 1:
            raise AssertionError(f"faults {schedule.faults}, {first}")
        head = corrupt.params["snapshot_id"]
        if len(chain) < 2 or chain[0] != head:
            raise AssertionError(f"chain {chain} at the corruption of {head}")
        clock = WallClock()
        cluster = JetCluster(n_nodes=1, cooperative_threads=1, clock=clock,
                             snapshot_dir=snap_dir)
        try:
            job2 = cluster.recover_job(
                paper_q5(dev, gen, total, cols, clock).to_dag())
            cold = job2.recovery_log[0]
            drive_job(cluster, job2, tracker)
        finally:
            cluster.shutdown()
        skipped = {s["snapshot_id"]: s["reason"] for s in cold["skipped"]}
        if (cold["event"] != "cold_start" or head not in skipped
                or "verification failed" not in skipped[head]
                or cold["restored_snapshot"] is None
                or cold["restored_snapshot"] >= head):
            raise AssertionError(f"the cold start did not fall back past "
                                 f"the corrupted head {head}: {cold}")
        if any(p.late_dropped or p.conflict_dropped or p.bucket_collisions
               for p in device_procs(job2)):
            raise AssertionError("drops or collisions after the cold start")
    torch.cuda.synchronize()
    launches = launch_counts()
    steps = tracker.check(launches, "(b)")

    ts, key = (np.frombuffer(cols[k], np.int64) for k in ("ts", "key"))
    value = np.frombuffer(cols["value"], np.float64)
    at = np.repeat(np.frombuffer(cols["now"], np.float64),
                   np.frombuffer(cols["count"], np.int64))
    rows = (ts + 1) // SLIDE_MS - 1
    if rows.min() < 0 or rows.max() >= oracle.shape[0] or \
            key.min() < 0 or key.max() >= N_AUCTIONS:
        raise AssertionError("a result outside the oracle's windows")
    flat = rows * N_AUCTIONS + key
    got = np.zeros(oracle.size, np.int64)
    got[flat] = value.astype(np.int64)
    # a replayed result must repeat its first delivery's value
    if not np.array_equal(got[flat], value) or \
            not np.array_equal(got, oracle.ravel()):
        bad = np.flatnonzero(got != oracle.ravel())
        raise AssertionError(f"{bad.size} (window, auction) counts differ "
                             f"from the oracle, e.g. {bad[:5]}")
    unique = int(np.unique(flat).size)
    res.update({
        "results": unique, "delivered": int(flat.size),
        "replayed": int(flat.size) - unique,
        "device_steps": steps, "accumulate_launches": launches["accumulate"],
        "accumulate_per_device_step": launches["accumulate"] / steps,
        "kill": {"at": kill.at_result, "fired_at_result": kill.fired_at_result,
                 **recovery_gap(flat, at, kill.fired_at_result,
                                kill.fired_at)},
        "corrupt_flip": {"at": corrupt.at_result, "snapshot": head,
                         "fired_at_result": corrupt.fired_at_result},
        "cold_start": {"restored_snapshot": cold["restored_snapshot"],
                       "skipped": cold["skipped"], "chain": cold["chain"],
                       **recovery_gap(flat, at, n_death, t_death)},
        "first_run": {k: first[k] for k in ("restarts", "snapshots",
                                             "chain")},
        "snapshots": rec["builds"], "spills": rec["spills"],
        "loads": rec["loads"], "restores": rec["restores"],
        "wall_s": time.perf_counter() - t_phase,
    })
    spills = {s["snapshot"]: s for s in rec["spills"]}
    for b in rec["builds"]:
        s = spills.get(b["snapshot"])
        log(f"faults (b): snapshot {b['snapshot']}: {b['entries']} entries "
            f"({b['pairs']} (frame, count) pairs) built in {b['s']:.4f} s, "
            + ("never committed" if s is None else
               f"spilled in {s['s']:.4f} s, {s['bytes']} bytes on disk"))
    for ld, r in zip(rec["loads"], rec["restores"]):
        log(f"faults (b): restore of snapshot {r['snapshot']}: chain walk "
            f"and read {ld['s']:.4f} s, {r['entries']} entries onto the "
            f"card in {r['s']:.4f} s")
    log(f"faults (b): recovery after the kill {json.dumps(res['kill'])}; "
        f"after the cold start {json.dumps(res['cold_start'])}")
    log(f"faults (b): {len(oracle)} windows x auctions equal the numpy "
        f"oracle exactly ({unique} results, {res['replayed']} replayed "
        f"deliveries); no drops or collisions; {steps} device steps, "
        f"{launches['accumulate']} accumulate launches; "
        f"{res['wall_s']:.1f} s")
    return res


def mp_run(stream: dict, backend: str, seed=None) -> dict:
    """Q5 with host placement over ``stream`` on MP_NODES x MP_THREADS,
    exactly-once: ``inproc`` on a virtual clock, ``mp`` (one process a
    worker) on the wall clock, with a seeded SIGKILL of one worker where
    a seed is given.  The deduplicated result set, the late drops and
    what the run did."""
    gen = NexmarkGenerator(rate=stream["rate"], n_keys=stream["n_keys"])
    clock = None
    if backend == "inproc":
        clock = VirtualClock(auto_step=0.001)
    elif "heartbeat_timeout_s" in stream:
        backend = MultiprocessBackend(
            heartbeat_timeout_s=stream["heartbeat_timeout_s"])
    cluster = JetCluster(n_nodes=MP_NODES, cooperative_threads=MP_THREADS,
                         backend=backend, clock=clock)
    out: list = []
    p = queries.q5(
        lambda: PacedGeneratorSource(gen, rate=stream["rate"],
                                     max_events=stream["events"]),
        lambda: CollectorSink(out), window_ms=stream["window_ms"],
        slide_ms=stream["slide_ms"])
    info: dict = {}
    t0 = time.perf_counter()
    try:
        job = cluster.submit(p.to_dag(), JobConfig(
            processing_guarantee=GUARANTEE_EXACTLY_ONCE,
            snapshot_interval_s=stream["snapshot_s"],
            restart_policy=RestartPolicy(max_restarts=4)))
        ctl = None
        if seed is not None:
            ctl = ChaosController(cluster, job, out, ChaosSchedule.from_seed(
                seed, n_faults=1, total_results=stream["results"],
                kinds=(KIND_KILL,), lo_frac=0.05, hi_frac=0.3),
                require_snapshot=stream["after_snapshot"])
        data = job.execution.backend_data
        info["workers"] = len(data.get("workers", {}))
        info["rings"] = [r.name for r in data.get("rings", ())]
        deadline = time.monotonic() + MP_RUN_DEADLINE_S
        while job.status not in (JOB_COMPLETED, JOB_FAILED):
            if time.monotonic() > deadline:
                raise AssertionError(f"{cluster.backend.name} job stuck: "
                                     f"{job.recovery_diagnostics()}")
            cluster.step()
            if ctl is not None:
                ctl.tick()
            if cluster.backend.name == "mp":
                info["rings"] += [r.name for r in job.execution.backend_data
                                  .get("rings", ()) if r.name not in
                                  info["rings"]]
        if job.status != JOB_COMPLETED:
            raise AssertionError(f"{cluster.backend.name} job {job.status}: "
                                 f"{job.recovery_diagnostics()}")
        drops = sum(getattr(t.processor, "late_dropped", 0)
                    for t in job.execution.tasklets)
        if ctl is not None:
            fault = ctl.schedule.faults[0]
            if not fault.fired or job.auto_restarts < 1:
                raise AssertionError(f"the SIGKILL did not heal: "
                                     f"{ctl.schedule.faults} {job.failures}")
            info["fault"] = {"at": fault.at_result,
                             "fired_at_result": fault.fired_at_result,
                             "failures": [f.kind for f in job.failures],
                             "restarts": job.auto_restarts,
                             "restored": [r["restored_snapshot"]
                                          for r in job.recovery_log
                                          if r["event"] == "restore"]}
    finally:
        cluster.shutdown()
    left = sorted(set(info.get("rings", ())) & set(os.listdir("/dev/shm")))
    if left:
        raise AssertionError(f"rings left in /dev/shm: {left}")
    results = {(ev.ts, ev.key, ev.value.window_end, ev.value.value)
               for ev in out}
    info.update({"results": len(results), "delivered": len(out),
                 "drops": drops, "wall_s": time.perf_counter() - t0,
                 "rings": len(info.get("rings", ()))})
    return {"set": results, "drops": drops, "info": info}


def mp_faults_child(out_path: Path) -> int:
    """``--mp-faults PATH`` (started by ``mp_faults``, with the card
    hidden): (c)'s runs; writes their summary to PATH."""
    if torch.cuda.is_available():
        raise AssertionError("the mp phase must run with the card hidden")
    res = {}
    for name, stream in (("reference_stream", MP_REF),
                         ("paper_stream", MP_PAPER)):
        clean = mp_run(stream, "inproc")
        stream = dict(stream, results=len(clean["set"]))
        got = {"inproc": clean["info"]}
        for label, seed in (("mp", None), ("mp_sigkill", MP_SEED)):
            run = mp_run(stream, "mp", seed)
            if run["set"] != clean["set"] or run["drops"] != clean["drops"]:
                raise AssertionError(
                    f"{name} {label}: {run['info']['results']} results, "
                    f"{run['drops']} drops; in process "
                    f"{len(clean['set'])}, {clean['drops']}")
            if run["info"]["workers"] != MP_NODES * MP_THREADS:
                raise AssertionError(f"{run['info']['workers']} workers")
            got[label] = run["info"]
        res[name] = got
        print(f"{name}: mp and mp through a SIGKILL equal in process "
              f"({len(clean['set'])} results); {json.dumps(got)}",
              flush=True)
    left = [n for n in os.listdir("/dev/shm")
            if n.startswith(RING_NAME_PREFIX)]
    if left:
        raise AssertionError(f"rings with the port's prefix left: {left}")
    res["cuda_initialized"] = torch.cuda.is_initialized()
    if res["cuda_initialized"]:
        raise AssertionError("the mp phase initialised CUDA")
    out_path.write_text(json.dumps(res))
    return 0


def mp_refuses_device(dev) -> str:
    """``q5(placement="device")`` on ``backend="mp"`` is refused before any
    worker starts (no fork, so this process's CUDA context is safe)."""
    cluster = JetCluster(n_nodes=1, cooperative_threads=2, backend="mp")
    p = queries.q5(lambda: PacedGeneratorSource(
                       NexmarkGenerator(rate=EQUIV_RATE, n_keys=40),
                       rate=EQUIV_RATE, max_events=EQUIV_EVENTS),
                   lambda: CollectorSink([]), window_ms=100, slide_ms=20,
                   placement="device", device=dict(EQUIV_DEVICE, device=dev))
    try:
        cluster.submit(p.to_dag(), JobConfig())
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("mp ran a device vertex")
    finally:
        cluster.shutdown()
    if multiprocessing.active_children():
        raise AssertionError("a worker process started")
    mine = f"{RING_NAME_PREFIX}{os.getpid()}_"
    left = [n for n in os.listdir("/dev/shm") if n.startswith(mine)]
    if left:
        raise AssertionError(f"the refused job left rings: {left}")
    return refused


def mp_faults(dev) -> dict:
    """(c): the mp runs in a subprocess started fresh with the card hidden
    (its forked workers inherit no CUDA context, and any CUDA call there
    raises), its process group killed at the time limit; then the refusal
    of a device vertex, here."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "mp.json"
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mp-faults",
             str(out)], env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=MP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise AssertionError(f"the mp phase took over {MP_TIMEOUT_S} s")
        for line in stdout.splitlines():
            log(f"faults (c) | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"the mp phase failed ({proc.returncode}):"
                                 f"\n{stderr[-4000:]}")
        res = json.loads(out.read_text())
    res["device_on_mp_refused"] = mp_refuses_device(dev)
    res["wall_s"] = time.perf_counter() - t0
    log(f"faults (c): {MP_NODES * MP_THREADS} worker processes equal in "
        f"process through a SIGKILL, no ring left, CUDA never initialised "
        f"there; device placement on mp refused: "
        f"{res['device_on_mp_refused']!r}; {res['wall_s']:.1f} s")
    return res


def faults_path(dev) -> dict:
    """Phase 12: (a), (b), then (c)."""
    t0 = time.perf_counter()
    res = {"reference_stream": faults_reference_stream(dev),
           "paper_shape": faults_paper_shape(dev),
           "mp": mp_faults(dev)}
    res["wall_s"] = time.perf_counter() - t0
    log(f"faults: phase 12 in {res['wall_s']:.1f} s")
    return res


# -- phase 11 ----------------------------------------------------------------
def route_timing_cases(dev):
    """Each route kernel at the 4-rank path's shape (rank 0's slice of a Q5
    step: 16 384 events, 4 destinations of 4 096 buckets, C = 8 192): its
    three calls (kernel, plain version, library yardstick or None) and its
    bound, the bytes it must move at 3.35 TB/s (inputs read once, outputs
    written once; about 0.025 us for the counts, so the launch dominates
    every call here).  The yardstick of the counts is one
    ``torch.bincount``, which the port never calls; the offsets and the
    pack have no single PyTorch call."""
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    ev = {k: torch.from_numpy(v).to(dev)
          for k, v in q5_events(gen, rank_seqs(7, 0)).items()}
    k_loc, cap = K // RANKS, max(8, int(B // RANKS / RANKS * 2.0))
    pids = torch.div(ev["key"], k_loc, rounding_mode="floor")
    valid = ev["valid"]
    n, p = pids.numel(), RANKS
    binned = torch.where(valid, pids, p)
    library = torch.bincount(binned, minlength=p + 1)[:p].to(torch.int32)
    if not torch.equal(library, route_counts(pids, valid, p)):
        raise AssertionError("bincount yardstick differs from route_counts")
    pack_args = (ev["ts"], ev["key"], ev["value"], valid, RANKS, k_loc, cap)
    return {
        "route_counts": ({
            "kernel": lambda: route_counts(pids, valid, p),
            "plain": lambda: route_counts_plain(pids, valid, p),
            "library": lambda: torch.bincount(binned, minlength=p + 1)},
            n * 5 + p * 4),
        "route_offsets": ({
            "kernel": lambda: route_offsets(pids, valid, p),
            "plain": lambda: route_offsets_plain(pids, valid, p)},
            n * 5 + 2 * p * 4),
        "route_pack": ({
            "kernel": lambda: route_pack(*pack_args, with_pos=False),
            "plain": lambda: route_pack_plain(*pack_args)},
            n * 13 + RANKS * 4 * cap * 4 + 4),
    }


def time_route(dev, entries: list) -> None:
    """The route kernels by CUDA events over 500 back-to-back calls, in
    turns, beside their plain versions and yardstick; before any profiler
    runs.  Fills ``entries`` (phase 3's, by name)."""
    by_name = {e["name"]: e for e in entries}
    for name, (fns, nbytes) in route_timing_cases(dev).items():
        times = {}
        for which in ("plain", "kernel", "library", "kernel", "plain"):
            if which in fns:
                times.setdefault(which, []).append(cuda_ms(fns[which],
                                                           iters=500))
        by_name[name].update({
            "ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
            "library_ms": min(times["library"]) if "library" in times
            else None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "events_ms": times})
        log(f"{name} timing at the path's shape: "
            f"{json.dumps(by_name[name])}")


def profile_route(dev, entries: list) -> None:
    """Device time alone (profiler) of each route kernel's calls."""
    by_name = {e["name"]: e for e in entries}
    for name, (fns, _) in route_timing_cases(dev).items():
        dev_only = {which: device_ms(fn) for which, fn in fns.items()}
        by_name[name].update({"device_ms": dev_only["kernel"],
                              "plain_device_ms": dev_only["plain"],
                              "library_device_ms": dev_only.get("library")})
        log(f"{name} device time (profiler) ms {json.dumps(dev_only)}")


def time_window_agg(dev) -> tuple[dict, dict]:
    """The window_agg op (no path runs it; phase 3 holds it) at the main
    path's inputs: one Q5 step's keys and slots into a fresh (16384, 1008)
    output, beside its plain version and its library yardstick (one
    index_add_ into a fresh zeroed vector, given the int64 flat index and
    masked values ready-made), by CUDA events over 200 calls in turns.
    Its bound: keys, slots, values and valid read once and the (K, R)
    output written once, at 3.35 TB/s.  Returns the timings and the three
    calls, for device time alone (profiler) later."""
    R = SPEC.ring_len
    b = q5_batch(NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS), 7)
    keys, vals, valid = (torch.from_numpy(b[k]).to(dev)
                         for k in ("key", "value", "valid"))
    slots = ((torch.from_numpy(b["ts"]).to(dev) // SLIDE_MS) % R).to(
        torch.int32)
    flat_idx = torch.where(valid, keys.long() * R + slots.long(), 0)
    flat_val = torch.where(valid, vals, 0.0)
    fns = {"kernel": lambda: window_agg(keys, slots, vals, valid, K, R),
           "plain": lambda: window_agg_plain_into_(
               torch.zeros((R, K), device=dev), keys, slots, vals,
               valid).t(),
           "library": lambda: torch.zeros(K * R, device=dev).index_add_(
               0, flat_idx, flat_val)}
    if not (torch.equal(fns["kernel"](), fns["plain"]())
            and torch.equal(fns["kernel"]().flatten(), fns["library"]())):
        raise AssertionError("window_agg timing: the three calls disagree")
    times = {}
    for label in ("plain", "kernel", "library", "kernel", "plain"):
        times.setdefault(label, []).append(cuda_ms(fns[label], iters=200))
    n = keys.numel()
    bytes_moved = n * (4 + 4 + vals.element_size() + 1) + K * R * 4
    res = {"ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
           "library_ms": min(times["library"]),
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes": bytes_moved, "events_ms": times}
    log(f"window_agg op timing at N={n} K={K} R={R}: {json.dumps(res)}")
    return res, fns


def profile_window_agg(fns: dict, entry: dict) -> None:
    """Device time alone (profiler) of the op's three timed calls."""
    dev_only = {label: device_ms(fn) for label, fn in fns.items()}
    entry.update({"device_ms": dev_only["kernel"],
                  "plain_device_ms": dev_only["plain"],
                  "library_device_ms": dev_only["library"]})
    log(f"window_agg op device time (profiler) ms {json.dumps(dev_only)}")


def time_accumulate(dev) -> dict:
    """The fused accumulate at a Q5 step (the main path's call: one step's
    batch into the paper's (1008, 16384) panes, frames 0..6 in the ring)
    beside the plain version, by CUDA events
    over 200 back-to-back calls in turns, then device time alone
    (profiler); and its bound: ts, key, value and valid read once,
    slot_frame read once, every pane cell the batch touches read and
    written once, at 3.35 TB/s.  No single PyTorch call computes
    accumulate, so there is no library yardstick."""
    rng = np.random.RandomState(11)
    b = q5_batch(NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS), 7)
    ts, key, value, valid = (torch.from_numpy(b[k]).to(dev)
                             for k in ("ts", "key", "value", "valid"))
    base = q5_state(dev, rng)
    states = {w: {k: v.clone() for k, v in base.items()}
              for w in ("kernel", "plain")}
    kw = acc_kw(SPEC)
    fns = {"kernel": lambda: accumulate_(states["kernel"], ts, key, value,
                                         valid, **kw),
           "plain": lambda: accumulate_plain_(states["plain"], ts, key,
                                              value, valid, **kw)}
    times = {}
    for label in ("plain", "kernel", "kernel", "plain"):
        times.setdefault(label, []).append(cuda_ms(fns[label], iters=200))
    dev_only = {label: device_ms(fn) for label, fn in fns.items()}
    # every call adds the same batch: the two states must agree
    for k in base:
        if k != "panes" and not torch.equal(states["kernel"][k],
                                            states["plain"][k]):
            raise AssertionError(f"timed accumulate runs disagree on {k}")
    cells = int(torch.unique(key[valid]).numel())
    n = key.numel()
    bytes_moved = (n * (4 + 4 + value.element_size() + 1)
                   + SPEC.ring_len * 4 + 8 * cells)
    res = {"ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes": bytes_moved, "library_ms": None,
           "device_ms": dev_only["kernel"],
           "plain_device_ms": dev_only["plain"],
           "events_ms": times}
    log(f"accumulate timing at N={n} K={K} R={SPEC.ring_len} "
        f"({int(valid.sum())} bids, {cells} cells): {json.dumps(res)}")
    return res


def q5_wall_ab(dev, n_steps: int = 300) -> dict:
    """Q5 wall ms a step with the fused accumulate and with the plain one
    on the card, in turns (plain, fused, fused, plain), before any
    profiler runs in this process."""
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    batches, _ = pinned_batches(gen, n_steps)
    cfg = StreamJobConfig(window=SPEC, batch_size=B)

    def feed(start, size):
        return batches[start // size]

    walls = {"fused": [], "plain": []}
    for which in ("plain", "fused", "fused", "plain"):
        with plain_accumulate() if which == "plain" else \
                contextlib.nullcontext():
            StreamExecutor(cfg).run_stream(feed, 32)            # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            StreamExecutor(cfg).run_stream(feed, n_steps)
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t0) / n_steps * 1e3)
    res = {"steps": n_steps, "wall_ms_per_step": walls,
           "fused_ms": min(walls["fused"]), "plain_ms": min(walls["plain"])}
    log(f"Q5 wall a step, fused accumulate against the plain one (in "
        f"turns): {json.dumps(res)}")
    return res


def new_kernel_resources(dev) -> dict:
    """Registers, spills and shared memory (ptxas) of the fused accumulate
    and of route_pack, and route_pack's cluster at the path's plan: blocks,
    threads, claims a block and clusters the card holds at once."""
    plan = pack_plan(B // RANKS, RANKS, max(8, int(B // RANKS / RANKS * 2.0)))
    blocks, threads, clusters = pack_cluster(plan.cells_per_block,
                                             dev.index or 0)
    res = {"accumulate_ptxas": ptxas_report("window_agg",
                                            "accumulate_kernel"),
           "route_pack_ptxas": ptxas_report("route", "route_pack_kernel"),
           "route_pack_cluster": {
               "blocks": blocks, "threads_a_block": threads,
               "rows_per_block": plan.rows_per_block,
               "cells_per_block": plan.cells_per_block,
               "dynamic_smem_bytes_a_block": plan.smem_bytes,
               "cluster_smem_bytes": plan.smem_bytes * blocks,
               "clusters_the_card_holds": clusters}}
    if (blocks, threads) != (plan.blocks, 1024) or clusters < 1:
        raise AssertionError(f"route_pack's cluster: {res}")
    log(f"new kernels' resources: {json.dumps(res)}")
    return res


def profile_main_path(dev, wall_ms_per_step: float, n_steps: int = 50,
                      plain: bool = False):
    """Where a main-path step's time goes: device time by kernel over a
    profiled stretch, against an unprofiled run's wall time per step;
    ``plain``: with the plain accumulate on the card."""
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    batches, _ = pinned_batches(gen, n_steps)
    cfg = StreamJobConfig(window=SPEC, batch_size=B)
    with plain_accumulate() if plain else contextlib.nullcontext():
        kernels = profiled(lambda: StreamExecutor(cfg).run_stream(
            lambda s, size: batches[s // size], n_steps), iters=1)
    busy = sum(ms for ms, _ in kernels.values()) / n_steps
    res = {"accumulate": "plain" if plain else "fused",
           "wall_ms_per_step": wall_ms_per_step,
           "device_ms_per_step": busy,
           "device_idle_share": 1 - busy / wall_ms_per_step,
           "device_launches_per_step": sum(
               c for _, c in kernels.values()) / n_steps}
    log(f"main path per step: {json.dumps(res)}; top device time per step:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, launches) in top:
        log(f"  {ms / n_steps:.5f} ms  x{launches / n_steps:.2f}  "
            f"{name[:100]}")
    res["top"] = [[name[:100], ms / n_steps, c / n_steps]
                  for name, (ms, c) in top]
    return res


def attention_bound(b, h, hk, n_valid, dh, dtype):
    """The least time for decode_attention's work: each of the n_valid
    cached rows of k and v read once, q read and the f32 output written
    once, against 4 * B * H * n_valid * dh operations at the type's peak."""
    isz = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * b * hk * n_valid * dh * isz + b * h * dh * (isz + 4)
    ops = 4 * b * h * n_valid * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def decode_timing_cases(dev):
    """Per timed shape: its label, shape, iterations and the three calls
    (kernel, plain version, library yardstick), inputs drawn on the card.
    The serve shape (f32, pos 1023) rotates over 8 caches so that, as on
    the path, the 134 MB read does not sit in the 50 MB L2; decode_32k is
    bf16 at B = 128, S = 32 768 with qwen2's heads.  The yardstick is one
    ``F.scaled_dot_product_attention(..., enable_gqa=True)`` on head-major
    copies, which the port never calls; None where it does not run."""
    d32 = SHAPES["decode_32k"]
    shapes = {"serve": (8, 12, 2, 1024, 128, torch.float32, 8, 200),
              "decode_32k": (d32.global_batch, 12, 2, d32.seq_len, 128,
                             torch.bfloat16, 1, 10)}
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, (b, h, hk, s, dh, dt, copies, iters) in shapes.items():
        def draw(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        pos = s - 1
        q = draw(b, h, dh)
        kv = [tuple(draw(b, s, hk, dh).permute(0, 2, 1, 3) for _ in "kv")
              for _ in range(copies)]
        heads = [(k.contiguous(), v.contiguous()) for k, v in kv]
        turn = [0]

        def rotating(fn, pairs):
            def call():
                k, v = pairs[turn[0] % copies]
                turn[0] += 1
                return fn(k, v)
            return call

        fns = {"kernel": rotating(
                   lambda k, v: decode_attention(q, k, v, pos), kv),
               "plain": rotating(
                   lambda k, v: decode_attention_plain(q, k, v, pos), kv),
               "library": rotating(
                   lambda k, v: F.scaled_dot_product_attention(
                       q.unsqueeze(2), k, v, enable_gqa=True), heads)}
        try:                     # the yardstick computes the same function
            lib_out = F.scaled_dot_product_attention(
                q.unsqueeze(2), *heads[0], enable_gqa=True)[:, :, 0]
            torch.testing.assert_close(lib_out.float(),
                                       decode_attention(q, *kv[0], pos),
                                       rtol=LIB_TOL[dt], atol=LIB_TOL[dt])
        except RuntimeError as e:
            log(f"decode_attention {label}: no library yardstick ({e})")
            del fns["library"]
        yield label, (b, h, hk, s, dh, dt, pos), iters, fns
        del q, kv, heads, fns
        torch.cuda.empty_cache()


def ptxas_report(name: str, needle: str) -> dict:
    """``{entry function: [ptxas lines]}`` for the entries of kernel
    library ``name`` whose mangled name holds ``needle``, from the
    ``-Xptxas -v`` log the build keeps."""
    text = _build.library_path(name).with_suffix(".log").read_text()
    report, entry = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and needle in entry and (
                "registers" in line or "spill" in line):
            report.setdefault(entry, []).append(line.strip())
    return report


def decode_kernel_resources(dev, dtype, dh) -> dict:
    """The decode kernel's block for ``dtype`` and ``dh``: registers and
    spills (runtime attributes, and ptxas' report of the instantiation),
    tile, stages and shared memory a block (the library's) and blocks
    resident an SM (the occupancy query), held to the wrapper's CPU mirror
    (``decode_block``)."""
    idx = dev.index or 0
    cfg = decode_attn.kernel_config(dtype, dh)
    card = decode_block(dtype, dh, idx)
    blocks, regs, spill = decode_attn.occupancy(dtype, dh, idx)
    tag = {torch.float32: "attn_kernelIfLi", torch.bfloat16:
           "attn_kernelI13__nv_bfloat16Li", torch.float16:
           "attn_kernelI6__halfLi"}[dtype] + ("128E" if dh <= 128 else "256E")
    res = {"dtype": str(dtype)[6:], "dh": dh, "registers": regs,
           "spill_bytes_a_thread": spill,
           "smem_bytes_a_block": card.smem_bytes,
           "stages": card.stages, "tile": card.tile,
           "blocks_an_sm": blocks, "blocks_an_sm_mirror": cfg.blocks_per_sm,
           "ptxas": [ln for lines in ptxas_report("decode_attn", tag).values()
                     for ln in lines]}
    log(f"decode_attention block: {json.dumps(res)}")
    return res


def time_decode_attention(dev) -> dict:
    """decode_attention beside its plain version and its library yardstick
    by CUDA events, in turns, and its bound; before any profiler runs."""
    res = {}
    for label, (b, h, hk, s, dh, dt, pos), iters, fns in \
            decode_timing_cases(dev):
        warm = 5 if iters > 20 else 2
        times = {}
        for which in ("plain", "kernel", "library", "kernel", "plain"):
            if which in fns:
                times.setdefault(which, []).append(
                    cuda_ms(fns[which], iters=iters, warmup=warm))
        bound_ms, bound_by, nbytes = attention_bound(b, h, hk, s, dh, dt)
        res[label] = {
            "shape": [b, h, hk, s, dh], "dtype": str(dt)[6:], "pos": pos,
            "ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
            "library_ms": min(times["library"]) if "library" in times
            else None,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "events_ms": times,
            "tb_per_s": nbytes / (min(times["kernel"]) * 1e-3) / 1e12,
            "peak_tb_per_s": HBM_BYTES_PER_S / 1e12,
            "block": decode_kernel_resources(dev, dt, dh)}
        log(f"decode_attention timing {label}: {json.dumps(res[label])}")
    serve = res["serve"]
    return {"ms": serve["ms"], "plain_ms": serve["plain_ms"],
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "library_ms": serve["library_ms"],
            "decode_32k": res["decode_32k"], "serve_shape": serve}


def profile_decode_attention(dev, timing: dict) -> None:
    """Device time alone (profiler) of the three calls at each timed shape,
    added to ``timing``; after the event timings, as the profiler slows
    every later launch."""
    for label, _, iters, fns in decode_timing_cases(dev):
        dev_only = {which: device_ms(fn, iters=min(iters, 20))
                    for which, fn in fns.items()}
        entry = timing["serve_shape" if label == "serve" else label]
        entry.update({"device_ms": dev_only["kernel"],
                      "plain_device_ms": dev_only["plain"],
                      "library_device_ms": dev_only.get("library")})
        if dev_only["kernel"]:
            entry["device_tb_per_s"] = (entry["bytes"] / (
                dev_only["kernel"] * 1e-3) / 1e12)
        log(f"decode_attention device time {label} (profiler) ms "
            f"{json.dumps(dev_only)}; "
            f"{entry.get('device_tb_per_s', 0):.3f} TB/s of the card's "
            f"{HBM_BYTES_PER_S / 1e12:.2f}")
    for key in ("device_ms", "plain_device_ms", "library_device_ms"):
        timing[key] = timing["serve_shape"][key]


def profile_serve(dev, cfg, params, step_ms) -> dict:
    """Where a serve step's time goes: PROFILE_STEPS steps of a fresh run
    profiled (device time by kernel) from position PROFILE_AT, against the
    unprofiled main run's host time at the same positions (``step_ms``;
    the profiler slows every launch after it starts) and against the bound
    of reading every weight and the attended KV cache once."""
    server = BatchedLMServer(cfg, params, batch_slots=SLOTS,
                             max_seq=MAX_SEQ, device=dev)
    pending = serve_prompts(cfg)
    # profiled() runs its function once before it profiles a second call
    serve_steps(server, pending, PROFILE_AT - PROFILE_STEPS)
    kernels = profiled(lambda: serve_steps(server, pending, PROFILE_STEPS),
                       iters=1)
    if server.pos != PROFILE_AT + PROFILE_STEPS:
        raise AssertionError(f"profiled stretch ended at {server.pos}")
    wall = float(np.mean(step_ms[PROFILE_AT:PROFILE_AT + PROFILE_STEPS]))
    busy = sum(ms for ms, _ in kernels.values()) / PROFILE_STEPS
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    # step at position p attends p + 1 rows: the mean over the stretch
    rows = PROFILE_AT + (PROFILE_STEPS + 1) / 2
    kv_bytes = (2 * cfg.n_layers * SLOTS * rows * cfg.n_kv_heads
                * cfg.head_dim_ * 4)
    res = {"from_pos": PROFILE_AT, "steps": PROFILE_STEPS,
           "wall_ms_per_step": wall, "device_ms_per_step": busy,
           "device_idle_share": 1 - busy / wall,
           "device_launches_per_step": sum(
               c for _, c in kernels.values()) / PROFILE_STEPS,
           "bound_ms_per_step": (weight_bytes + kv_bytes)
           / HBM_BYTES_PER_S * 1e3}
    log(f"serve per step: {json.dumps(res)}; top device time per step:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, launches) in top:
        log(f"  {ms / PROFILE_STEPS:.5f} ms  x{launches / PROFILE_STEPS:.2f}"
            f"  {name[:100]}")
    res["top"] = [[name[:100], ms / PROFILE_STEPS, n / PROFILE_STEPS]
                  for name, (ms, n) in top]
    return res


def ranks_only(name: str, smi: str) -> int:
    """``--ranks``: phase 9 alone (after the card and the build), for a
    host with 4 cards, where the ranks run over NCCL."""
    ranks = q5_ranks()
    print(json.dumps({"q5_ranks": ranks}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def engine_only(name: str, smi: str) -> int:
    """``--engine``: phase 10 alone, after the card and the build."""
    print(json.dumps({"engine": engine_path(torch.device("cuda"))}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


def faults_only(name: str, smi: str) -> int:
    """``--faults``: phase 12 alone, after the card and the build."""
    print(json.dumps({"faults": faults_path(torch.device("cuda"))}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--mp-faults"] and len(sys.argv) == 3:
        return mp_faults_child(Path(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name, smi = card()
    build()
    if sys.argv[1:] == ["--ranks"]:
        return ranks_only(name, smi)
    if sys.argv[1:] == ["--engine"]:
        return engine_only(name, smi)
    if sys.argv[1:] == ["--faults"]:
        return faults_only(name, smi)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    window = check_window_agg(dev)
    acc = check_accumulate(dev)
    attn = check_decode_attention(dev)
    routes = check_route(dev)
    path = main_path(dev, MAIN_STEPS)
    window["launches"] = path["launches"]["window_agg"]
    acc["launches"] = path["launches"]["accumulate"]
    lat = latency(dev, LATENCY_STEPS)
    summ = summing(dev, SUMMING_STEPS)
    cfg = get_config(ARCH)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            torch.float32, device=dev)
    serve, server, step_ms = serve_path(dev, cfg, params)
    attn["launches"] = serve["decode_attention_launches"]
    tf32 = tf32_step(dev, cfg, server)
    del server
    vs_cpu = card_vs_cpu(dev)
    ranks = q5_ranks()
    for entry in routes:
        entry["launches"] = ranks["route"]["launches"][entry["name"]]
    engine = engine_path(dev)
    # phase 12 before phase 11: the profiler slows every launch after it
    faults = faults_path(dev)
    acc["launches_by_path"] = {
        "q5_run_stream": path["launches"]["accumulate"],
        "q5_ranks_route": ranks["route"]["launches"]["accumulate"],
        "engine_equivalence": engine["equivalence"]["accumulate_launches"],
        "engine_paced": engine["paced"]["accumulate_launches"],
        "faults_reference_stream":
            faults["reference_stream"]["accumulate_launches"],
        "faults_paper_shape": faults["paper_shape"]["accumulate_launches"]}
    acc["launches"] = sum(acc["launches_by_path"].values())
    # phase 11: event timings first, then the profiler
    ab = q5_wall_ab(dev)
    attn.update(time_decode_attention(dev))
    time_route(dev, routes)
    op_timing, op_calls = time_window_agg(dev)
    window.update(op_timing)
    acc.update(time_accumulate(dev))
    resources = new_kernel_resources(dev)
    acc["resources"] = resources["accumulate_ptxas"]
    routes[2]["resources"] = {k: resources[k] for k in (
        "route_pack_ptxas", "route_pack_cluster")}
    profile_route(dev, routes)
    profile_window_agg(op_calls, window)
    profile_decode_attention(dev, attn)
    prof = profile_main_path(dev, ab["fused_ms"])
    prof_plain = profile_main_path(dev, ab["plain_ms"], plain=True)
    serve_prof = profile_serve(dev, cfg, params, step_ms)
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s")
    print(json.dumps({"main_path": path, "latency": lat, "summing": summ,
                      "q5_wall_ab": ab, "profile": prof,
                      "profile_plain_accumulate": prof_plain,
                      "serve": serve, "serve_tf32": tf32,
                      "serve_card_vs_cpu": vs_cpu,
                      "serve_profile": serve_prof, "q5_ranks": ranks,
                      "engine": engine, "faults": faults,
                      "total_s": total}))
    print(json.dumps({"kernels": [window, acc, attn, *routes]}))
    print(smi)
    # the run uses one card, whatever the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
