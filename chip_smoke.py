#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments, on a machine with a
CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

``python3 chip_smoke.py --ranks`` runs phases 1, 2 and 9 alone (on a
host with 4 cards: the ranks over NCCL, a card each); ``python3
chip_smoke.py --engine`` runs phases 1, 2 and 10 alone; ``python3
chip_smoke.py --faults`` runs phases 1, 2 and 12 alone; ``python3
chip_smoke.py --lm`` runs phases 1, 2 and 13 alone; ``python3
chip_smoke.py --train`` runs phases 1, 2 and 14 alone; ``python3
chip_smoke.py --mesh`` runs phases 1, 2 and 15 alone (on a host with 4
cards: the ranks over NCCL, a card each).

It drives six paths of the port: device-tier NEXMark Q5 on one card
(``window_agg``'s library: one fused ``accumulate`` and one ``emit``
launch a step), LM serving (``decode_attention``), Q5 across 4 ranks
under the route exchange (one ``route_pack`` cluster launch, one
``accumulate`` and one ``emit`` a rank a step), the paper's main path:
``queries.q5(placement="device")`` through the port's host engine into
its ``DeviceWindowProcessor`` (one ``accumulate`` and one ``emit`` a
device step), and that path through seeded faults, a durable snapshot
chain and a cold start (one ``accumulate`` and one ``emit`` a device
step, the replays included), every LM family of the registry
(``decode_attention`` on every attention layer's decode, the rolling and
the linear sliding-window caches and the int8 cache included), and
training (no kernel: the gradients come from autograd over the plain
modules, as the reference's come from ``jax.value_and_grad``), and
training on a mesh of 4 ranks (no kernel either).  The
``window_agg`` op, ``route_counts`` and ``route_offsets`` are held in
phases 3 and 11 as the TPU kernels' counterparts and launch on no path.
Phases, in order of number; phases 12 to 15 run between 10 and 11,
before 11's profiler slows every launch after it.  Any failure ends
the run with a non-zero exit and no result line:

1. card: its name and power limit (``nvidia-smi``);
2. build: every kernel from ``src/repro_torch/kernels/csrc`` with
   ``nvcc``, one process per source, all started together;
3. kernels: the window_agg op, decode_attention and the route kernels
   against their plain PyTorch versions on the card, at their paths'
   shapes and at edge shapes (route_pack also over memory poisoned first,
   and as the route plan calls it, without positions; decode_attention
   also with its lower bound, the linear sliding-window cache's, at the
   serve shapes and the edges); the fused accumulate and emit are held
   against theirs at their paths' shapes in phase 11, over the whole
   window state, and at edge shapes by ``pytest -m cuda
   tests/test_torch_cuda.py``;
4. Q5 path: device-tier NEXMark Q5 through ``StreamExecutor.run_stream``
   at the paper's configuration (10 s window sliding by 10 ms over 10 000
   auctions, 16 384 key buckets, 65 536 events per step), fed numpy
   columns as the bridge feeds it, held exactly against an independent
   numpy oracle, with exactly one accumulate launch, one emit launch, one
   host read and one pinned slot fill a step;
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
   full-width panes a rank a step, through the host on gloo); then a
   profiled stretch of the route step on rank 0;
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
11. timing: each kernel at its path's shape beside its plain version
    (``accumulate`` and ``emit`` first checked equal to it), its library
    yardstick and its bound (``emit`` at a catch-up step of 8
    windows; ``decode_attention`` also at the ``decode_32k`` shape, and
    there with ``lo`` on mixtral's linear sliding-window cache: the last
    4 096 of 32 768 rows); ptxas' registers, spills and shared memory of
    the new kernels and route_pack's cluster; then a profiled stretch of
    serving and of one full-width train step of phase 14 (a) (device time
    by kernel, the device's idle share) — last, because the profiler
    slows every launch after it.  Q5's time a step and its breakdown are
    the benchmark's (``jetbench/run.py``);
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
    worker, equal to the in-process run, no ring left; (d)'s scenario
    with host placement; and ``q5(placement="device")`` on ``mp``
    refused.  (d) F9 (ROADMAP.md §3): phase 10 (a)'s stream with device
    placement on two nodes, exactly-once, where source instance 0 runs to
    the end while the others hold halfway; a snapshot begun after
    instance 0 finished commits, the node dies right after that commit
    and the held instances go on: the restored ``DeviceWindowProcessor``
    and sources must give the clean run's result and the numpy oracle's,
    one ``accumulate`` a device step, replays included;
13. LM families, bf16, random weights from a seed, each through a
    ``BatchedLMServer`` of 8 slots fed from ``transformer.prefill``: (a)
    mixtral-8x7b at full width cut to 8 of its 32 layers (its 93 GB of
    experts do not fit one card), a 4 608-token prefill (past the 4 096
    window: the chunked path and the rolled cache; layer 0's chunked
    attention against ``_sdpa_full``), 64 decode steps on the rolling
    cache; (b) rwkv6-7b whole, 512 + 128; (c) jamba-v0.1-52b cut to one
    of its 4 groups, 512 + 64; each with ``decode_attention`` once an
    attention layer a step and one more step through the kernel against
    the plain version; (d) qwen2-1.5b in float32 with an int8 cache
    beside a float32 one (the reference's test's types), 256
    teacher-forced steps within the reference's criterion, then a linear
    sliding-window cache decoded past its window, kernel against plain
    within 1e-3; (e) mixtral and rwkv6 at full width cut to 2 layers,
    float32, card against CPU, 8 teacher-forced steps, and rwkv6's
    prefill then a decode step against a prefill one token longer, on the
    card;
14. training: (a) olmo-1b at full width (16 layers, d_model 2048, vocab
    50 304) at the reference's train_4k sequence of 4 096, the batch cut
    from 256 to 8 in 2 microbatches, float32 parameters and AdamW, bf16
    compute, remat "nothing": 10 steps from ``launch/train.py``'s step
    builder on ``SyntheticLMData``, every loss and grad norm finite and
    the last loss below the first; it prints ms a step, tokens/s, peak
    memory and the model FLOPs' share of the bf16 peak; (b) reduced
    olmo-1b, mixtral-8x7b and jamba in float32, 2 steps from one state on
    the card and on the CPU, loss, grad norm, parameters and AdamW's
    moments within 1e-4; (c) ``launch.train.main --resume`` on the card (6
    straight steps against 3 + 3, rel 1e-4), and an async checkpoint
    followed at once by a step restores the state at the save exactly;
15. mesh: 4 spawned ranks (NCCL with a card a rank on a host with 4
    cards, else ``gloo_host``, the 4 ranks sharing this card with every
    collective staged through pinned host memory), parameters, AdamW's
    moments and batches placed as DTensors by ``sharding/rules.py``: (a)
    olmo-1b at full width through ``launch/train.py``'s trainer on a 2x2
    mesh, seq 2 048 (train_4k's 4 096 cut: four processes share one
    card), batch 8 in 2 microbatches, 5 steps, every loss finite and the
    last below the first; it prints per rank ms a step, tokens/s, peak
    memory and one step's collective calls and bytes, beside one process
    at the same shape; (b) olmo-1b (a train step on 2x2 and 1x4) and
    mixtral-8x7b (forward and loss on 1x4, layer 0's routing) at full
    width cut to 2 layers in float32, against the one-process port on
    the card within 1e-4, the routing exactly; (c) mixtral-8x7b cut to 4
    of 32 layers in bf16, expert-parallel on 1x4 (2 experts a rank), a
    forward of 8 x 512: ms, peak memory and the expert psum's bytes a
    layer; (d) ``launch/dryrun.py`` on the host for the three cells of
    the reference's multipod test: argument and peak GB a device and
    ``fits_80gb``, each within 80 GB;

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
import gc
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
from repro_torch.devices import ieee_fp32_matmul  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.kernels import _build, decode_attn  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.route import (  # noqa: E402
    pack_cluster, pack_plan, route_counts, route_counts_plain, route_offsets,
    route_offsets_plain, route_pack, route_pack_plain)
from repro_torch.kernels.window_agg import (  # noqa: E402
    accumulate_, accumulate_plain_, emit_, emit_plain_, window_agg,
    window_agg_plain_into_)
from repro_torch.launch.mesh import (  # noqa: E402
    make_data_mesh, make_smoke_mesh, ranks_backend, spawn_ranks)
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import BatchedLMServer  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import lm, transformer  # noqa: E402
from repro_torch.models.layers import apply_norm, apply_rope  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_numpy, opt_state_to_numpy, params_from_numpy,
    params_to_numpy)
from repro_torch.nexmark import NexmarkGenerator, queries  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.data import SyntheticLMData  # noqa: E402
from repro_torch.sharding import constraints, rules  # noqa: E402
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
    emit_.launches = 0
    decode_attention.launches = 0
    route_counts.launches = 0
    route_offsets.launches = 0
    route_pack.launches = 0


def launch_counts() -> dict:
    return {"window_agg": window_agg.launches,
            "accumulate": accumulate_.launches,
            "emit": emit_.launches,
            "decode_attention": decode_attention.launches,
            "route_counts": route_counts.launches,
            "route_offsets": route_offsets.launches,
            "route_pack": route_pack.launches}


def q5_launches(counts: dict, steps: int, **more) -> dict:
    """What a Q5 path may launch in ``steps`` steps: one ``accumulate`` and
    one ``emit`` a step, the launches in ``more``, nothing else."""
    return dict.fromkeys(counts, 0) | {"accumulate": steps,
                                       "emit": steps} | more


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
    for dt, err in decode_attention_lower_bound(dev).items():
        errs[dt] = max(errs[dt], err)
    decode_attention_rejects(dev)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
            "replaces": "src/repro/kernels/decode_attn.py:65",
            "max_abs_err": errs[f32], "max_abs_err_bf16": errs[bf16],
            "max_abs_err_f16": errs[f16]}


def decode_attention_lower_bound(dev) -> dict:
    """The lower bound ``lo`` (the linear sliding-window cache) against the
    plain version at the serve shape (8 slots, qwen2's 12 over 2 heads,
    mixtral's 32 over 8, dh 128, S = 1024 and 4096) and at the edges:
    ``lo = 0``, ``lo = pos``, inside the first 64-row tile, inside the last
    one, and with ``pos >= S``; each within 2e-5 and one launch.  Returns
    the largest error a type."""
    rng = np.random.RandomState(5)
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        for b, h, hk, s, pos, lo in [(8, 12, 2, 1024, 1000, 0),
                                     (8, 12, 2, 1024, 1000, 1000),
                                     (8, 12, 2, 1024, 1000, 5),
                                     (8, 12, 2, 1024, 1000, 970),
                                     (8, 12, 2, 1024, 1000, 937),
                                     (8, 12, 2, 1024, 1500, 1023),
                                     (8, 32, 8, 4096, 4000, 3937)]:
            q = torch.from_numpy(rng.randn(b, h, 128).astype(np.float32)).to(
                dev, dt)
            k, v = (cache_view(rng, b, s, hk, 128, dt, dev)
                    for _ in range(2))
            before = decode_attention.launches
            got = decode_attention(q, k, v, pos, lo)
            torch.cuda.synchronize()
            if decode_attention.launches != before + 1:
                raise AssertionError("lower bound: the kernel did not launch")
            want = decode_attention_plain(q, k, v, pos, lo)
            torch.testing.assert_close(got, want, rtol=ATTN_TOL,
                                       atol=ATTN_TOL)
            err = float((got - want).abs().max())
            errs[dt] = max(errs.get(dt, 0.0), err)
            log(f"decode_attention lower bound {str(dt)[6:]} q "
                f"{tuple(q.shape)} S {s} pos {pos} lo {lo}: "
                f"max_abs_err={err:.3g} ok")
    return errs


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
def batches_ahead(seqs_of, n_steps: int):
    """``n_steps`` Q5 batches generated ahead as numpy columns, as the
    bridge hands batches to the executor (batch ``i`` holds the events of
    sequence numbers ``seqs_of(i)``, all in frame ``i``), and the
    per-frame bid histogram of each over all K buckets (the oracle's
    input)."""
    gen = NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS)
    batches, hist = [], np.zeros((n_steps, K), np.int32)
    for i in range(n_steps):
        b = q5_events(gen, seqs_of(i))
        if not (b["ts"] // SLIDE_MS == i).all():
            raise AssertionError(f"step {i} spans more than frame {i}")
        batches.append(b)
        hist[i] = np.bincount(b["key"][b["valid"]], minlength=K)
    return batches, hist


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
    t0 = time.perf_counter()
    batches, hist = batches_ahead(lambda i: rank_seqs(i, 0, 1), n_steps)
    log(f"main path: {n_steps} batches of {B} events generated as numpy "
        f"columns in {time.perf_counter() - t0:.1f} s")
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
    counts = launch_counts()

    oracle = window_oracle(hist)
    n_windows = check_against_oracle(results, oracle, n_steps, exact=True)
    full = max(0, n_steps - SPEC.frames_per_window)
    drops = (int(state["dropped_late"]), int(state["dropped_conflict"]))
    if drops != (0, 0):
        raise AssertionError(f"dropped (late, conflict) = {drops}")
    # one accumulate launch, one emit launch, one host read and one pinned
    # slot fill a step, and no other kernel
    if (counts != q5_launches(counts, n_steps) or ex.host_syncs != n_steps
            or ex.stage_slot_fills != n_steps):
        raise AssertionError(f"in {n_steps} steps: launches {counts}, "
                             f"{ex.host_syncs} host syncs, "
                             f"{ex.stage_slot_fills} pinned slot fills")
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
        "stage_slot_fills": ex.stage_slot_fills,
        "stage_slot_waits": ex.stage_slot_waits,
        "result_chunks": ex.result_chunks,
        "result_ring_waits": ex.result_ring_waits,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts,
    }
    log(f"main path: {n_windows} windows ({full} full) equal the numpy "
        f"oracle exactly; drops 0; {json.dumps(out)}")

    return out


# -- phase 5 -----------------------------------------------------------------
def latency(dev, n_steps: int, warmup: int = 50) -> dict:
    """device_q5_latency's clock: from the batch existing on the host to
    the step's window results being on the host, one step at a time.  Each
    sample splits into staging (the fill of a pinned slot and its copy
    queued), the step (it waits for the device once, at emission's read)
    and the sink copy."""
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
    # exactly: one accumulate and one emit a step, one route_pack a route
    # step (its histogram is route_counts' device function inside it), and
    # no standalone route_counts or route_offsets
    want = q5_launches(launches, n_steps, route_pack=n_steps
                       if cfg.exchange == "route" else 0)
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{cfg.exchange}: {k} launched "
                                 f"{launches[k]} times in {n_steps} steps")
    if ex.host_syncs != n_steps:
        raise AssertionError(f"{cfg.exchange}: {ex.host_syncs} host syncs "
                             f"in {n_steps} steps")
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
    # this rank's slice of every step (no rank makes another's events)
    batches, hist = batches_ahead(lambda i: rank_seqs(i, rank, world),
                                  max(route_steps, reduce_steps))
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
    out["profile"] = rank_profile(rank, mesh, dev, feed, profile_steps,
                                  out["route"]["wall_ms_per_step"])
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
    res["profile"] = prof = per_rank[0]["profile"]
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
    if launches != q5_launches(launches, steps):
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
        """One ``accumulate`` and one ``emit`` launch a device step,
        nothing else, every processor on the card; returns the steps."""
        steps = self.steps()
        if any(p.executor.device.type != "cuda"
               for p in self.procs.values()):
            raise AssertionError(f"{what}: a device vertex off the card")
        if launches != q5_launches(launches, steps):
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
    fin = finished_source_check(None, "host", "mp")
    res["finished_source"] = fin
    print(f"finished_source: (d) on mp, host placement: restored after "
          f"source instance 0 finished, equal to the clean run and the "
          f"oracle ({fin['results']} results); {json.dumps(fin)}",
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


#: (d): where the held source instances stop until released (a seq)
F9_HOLD_SEQ = EQUIV_EVENTS // 2
F9_DEADLINE_S = 120.0


class HeldSource(PacedGeneratorSource):
    """(d)'s source: instance 0 runs to the end of the stream and then
    creates ``finished`` in the directory ``marks``; every other instance
    stops at ``F9_HOLD_SEQ`` until ``released`` exists there.  Files, so
    that worker processes of ``backend="mp"`` see them too."""

    def __init__(self, marks: str, **kw):
        super().__init__(**kw)
        self.marks = marks
        self._released = False

    def complete(self) -> bool:
        if not self._released:
            self._released = os.path.exists(
                os.path.join(self.marks, "released"))
        if self._released or self.ctx.global_index == 0:
            done = super().complete()
            if done:
                Path(self.marks, "finished").touch()
            return done
        full, self.max_events = self.max_events, F9_HOLD_SEQ
        try:
            super().complete()
        finally:
            self.max_events = full
        return False


def small_q5_oracle(gen, total: int, window_ms: int = 100,
                    slide_ms: int = 20) -> set:
    """Every ``(window_end, auction, count)`` of a Q5 window over the
    generator's first ``total`` events, from their sequence numbers."""
    blk = gen.gen_block(np.arange(total))
    bid = blk.cols["kind"] == 2
    counts: dict = {}
    for ts, key in zip(blk.ts[bid].tolist(), blk.key[bid].tolist()):
        first = (ts // slide_ms + 1) * slide_ms
        for w in range(first, first + window_ms, slide_ms):
            counts[(w, key)] = counts.get((w, key), 0) + 1
    return {(w, k, c) for (w, k), c in counts.items()}


def finished_source_run(dev, placement: str, backend: str, marks: Path,
                        kill: bool, tracker=None) -> dict:
    """(d)'s Q5 over ``HeldSource`` on 2 nodes x 2 threads, exactly-once;
    with ``kill``, the last node dies right after the first commit of a
    snapshot begun once instance 0 finished, then the held instances go
    on.  Without it, ``marks`` must already hold ``released``."""
    gen = NexmarkGenerator(rate=EQUIV_RATE, n_keys=40)
    clock = VirtualClock(auto_step=0.001) if backend == "inproc" else None
    cluster = JetCluster(n_nodes=2, cooperative_threads=2, backend=backend,
                         clock=clock)
    out: list = []
    device = dict(EQUIV_DEVICE, device=dev) if placement == "device" \
        else None
    p = queries.q5(
        lambda: HeldSource(str(marks), gen_fn=gen, rate=EQUIV_RATE,
                           max_events=EQUIV_EVENTS),
        lambda: CollectorSink(out), window_ms=100, slide_ms=20,
        placement=placement, device=device)
    gate, killed = None, False
    t0 = time.perf_counter()
    try:
        job = cluster.submit(p.to_dag(), JobConfig(
            processing_guarantee=GUARANTEE_EXACTLY_ONCE,
            snapshot_interval_s=FAULT_SNAPSHOT_VIRTUAL_S))
        deadline = time.monotonic() + F9_DEADLINE_S
        while job.status not in (JOB_COMPLETED, JOB_FAILED):
            if time.monotonic() > deadline:
                raise AssertionError(f"(d) job stuck (gate {gate}): "
                                     f"{job.recovery_diagnostics()}")
            cluster.step()
            if tracker is not None:
                tracker.see(job)
            if not kill or killed:
                continue
            if gate is None and (marks / "finished").exists():
                gate = job.execution.ssctx.requested_id + 1
            sid = cluster.snapshot_store.latest_committed(job.id)
            if gate is not None and sid is not None and sid >= gate:
                cluster.kill_node(cluster.node_ids[-1])
                killed = True
                (marks / "released").touch()
        if job.status != JOB_COMPLETED:
            raise AssertionError(f"(d) job {job.status}: "
                                 f"{job.recovery_diagnostics()}")
        if kill and (not killed or job.restarts < 1):
            raise AssertionError(f"(d) the node was not killed after a "
                                 f"commit past instance 0's end (gate "
                                 f"{gate})")
        drops = sum(getattr(t.processor, "late_dropped", 0)
                    for t in job.execution.tasklets)
    finally:
        cluster.shutdown()
    results = {(ev.value.window_end, ev.key, ev.value.value) for ev in out}
    if len({(w, k) for w, k, _v in results}) != len(results):
        raise AssertionError(f"(d) {placement} on {backend}: a window "
                             f"carries two values")
    return {"set": results, "drops": drops, "gate": gate,
            "restarts": job.restarts, "snapshots": job.snapshots_taken,
            "wall_s": time.perf_counter() - t0}


def finished_source_check(dev, placement: str, backend: str) -> dict:
    """(d): the clean run, then the run through the gated kill; both must
    equal the numpy oracle, and with device placement make one
    ``accumulate`` launch a device step."""
    oracle = small_q5_oracle(NexmarkGenerator(rate=EQUIV_RATE, n_keys=40),
                             EQUIV_EVENTS)
    res: dict = {"results": len(oracle), "accumulate_launches": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for label, kill in (("clean", False), ("kill", True)):
            marks = Path(tmp, label)
            marks.mkdir()
            if not kill:
                (marks / "released").touch()
            tracker = DeviceSteps() if placement == "device" else None
            zero_counts()
            run = finished_source_run(dev, placement, backend, marks, kill,
                                      tracker)
            if tracker is not None:
                launches = launch_counts()
                run["device_steps"] = tracker.check(launches, f"(d) {label}")
                res["accumulate_launches"] += launches["accumulate"]
            if run["set"] != oracle or run["drops"]:
                raise AssertionError(
                    f"(d) {placement} on {backend}, {label}: "
                    f"{len(run['set'])} results, {run['drops']} drops; the "
                    f"oracle {len(oracle)} results, "
                    f"{len(run['set'] - oracle)} not in it, "
                    f"{len(oracle - run['set'])} missing")
            run.pop("set")
            res[label] = run
    return res


def faults_finished_source(dev) -> dict:
    """(d) on the card: device placement, in process."""
    t0 = time.perf_counter()
    res = finished_source_check(dev, "device", "inproc")
    res["wall_s"] = time.perf_counter() - t0
    log(f"faults (d): restored after source instance 0 finished (gate "
        f"snapshot {res['kill']['gate']}), equal to the clean run and the "
        f"oracle ({res['results']} results), one accumulate a device step; "
        f"{json.dumps(res)}")
    return res


def faults_path(dev) -> dict:
    """Phase 12: (a), (b), (c), then (d)."""
    t0 = time.perf_counter()
    res = {"reference_stream": faults_reference_stream(dev),
           "paper_shape": faults_paper_shape(dev),
           "mp": mp_faults(dev),
           "finished_source": faults_finished_source(dev)}
    res["wall_s"] = time.perf_counter() - t0
    log(f"faults: phase 12 in {res['wall_s']:.1f} s")
    return res


# -- phase 13 ----------------------------------------------------------------
# every LM family of the registry on the card, bf16, random weights from a
# seed; the cuts keep full width and drop depth to fit one card's 80 GB
LM_SLOTS = 8
#: mixtral-8x7b: 32 layers of 2.9 GB of experts (93 GB) cut to 8 (24 GB);
#: a prompt past the 4 096 window takes the chunked path and the SWA roll
MIXTRAL_LAYERS, MIXTRAL_PROMPT, MIXTRAL_DECODE = 8, 4608, 64
#: rwkv6-7b whole (15 GB)
RWKV_PROMPT, RWKV_DECODE = 512, 128
#: jamba-v0.1-52b (104 GB) cut to one of its 4 groups: 7 Mamba layers and
#: one attention layer, 4 of the 8 with 16 experts (26 GB)
JAMBA_LAYERS, JAMBA_PROMPT, JAMBA_DECODE = 8, 512, 64
#: qwen2-1.5b with an int8 cache against the bf16 cache, teacher-forced
INT8_STEPS = 256
#: the linear sliding-window cache: a window of 64 over a prefill of 60
#: tokens padded to 256 rows, decoded past the window
SWA_WINDOW, SWA_PROMPT, SWA_ROWS, SWA_DECODE = 64, 60, 256, 16
#: card against CPU: mixtral and rwkv6 at full width cut to 2 layers
LM_CPU_LAYERS, LM_CPU_STEPS = 2, 8
#: the reference's criterion for an int8 cache against a float one
#: (tests/test_prefill_decode_continuity.py:100): the largest logit error
#: under 0.15 of the logits' standard deviation; also held by bf16 paths
#: against their plain versions, where the difference is a kernel's f32
#: sum order rounded to bf16 at each layer
SPREAD_TOL = 0.15
#: _sdpa_chunked against _sdpa_full in bf16: both round the probabilities
#: to bf16 before the PV product (the chunked path unnormalised, a chunk at
#: a time) and the product to bf16 (0.4 % each)
CHUNK_TOL = dict(rtol=3e-2, atol=3e-2)


@contextlib.contextmanager
def plain_decode_attention():
    """Within the block, the model's decode attention runs the plain
    version on the card: the yardstick of phase 13's comparisons, never a
    path's run."""
    kernel = attn_mod.decode_attention
    attn_mod.decode_attention = decode_attention_plain
    try:
        yield
    finally:
        attn_mod.decode_attention = kernel


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def lm_server(dev, cfg, seed: int, max_seq: int):
    """Random float32 weights from ``seed`` on the card, handed to a bf16
    ``BatchedLMServer`` of LM_SLOTS slots (which casts them, keeping the
    router, A_log, D, w0 and u in float32)."""
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), torch.float32, device=dev)
    server = BatchedLMServer(cfg, params, batch_slots=LM_SLOTS,
                             max_seq=max_seq, compute_dtype=torch.bfloat16,
                             device=dev)
    kept = {n: str(p.dtype)[6:] for n, p in server.params.named_parameters()
            if n.rsplit(".", 1)[-1] in transformer.F32_TENSORS}
    if any(v != "float32" for v in kept.values()):
        raise AssertionError(f"float32 tensors cast: {kept}")
    return server, len(kept)


def spread_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max |got - want| over std(want), held under SPREAD_TOL; finite."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite logits")
    rel = float((got - want).abs().max() / want.float().std())
    if not rel < SPREAD_TOL:
        raise AssertionError(f"{what}: logit error {rel:.3g} of the spread "
                             f">= {SPREAD_TOL}")
    return rel


def clone_cache(cache):
    return [{k: t.clone() for k, t in c.items()} for c in cache]


def prefill_into_server(server, cfg, prompts):
    """``transformer.prefill`` of ``prompts`` (LM_SLOTS, S) on the card,
    its cache copied into the server's (the attention layers' rows: the
    server's, so a rolled window is not padded), the server at position S
    and one request a slot whose prompt is the slot's greedy token after
    the prefill: the first server step decodes it at position S."""
    rows = max((c["k"].shape[1] for c in server.cache if "k" in c),
               default=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(cfg, server.params, tokens=prompts,
                                        compute_dtype=torch.bfloat16,
                                        kv_pad_to=rows)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    for dst, src in zip(server.cache, cache):
        if dst.keys() != src.keys():
            raise AssertionError(f"prefill cache {sorted(src)} against "
                                 f"{sorted(dst)}")
        for k in dst:
            if dst[k].shape != src[k].shape:
                raise AssertionError(f"prefill cache {k} {tuple(src[k].shape)}"
                                     f" against {tuple(dst[k].shape)}")
            dst[k].copy_(src[k])
    first = logits.argmax(-1).tolist()
    server.pos = prompts.shape[1]
    return logits, prefill_s, first


def lm_family(dev, cfg, prompt_len: int, decode_steps: int, seed: int,
              check_chunked: bool = False) -> dict:
    """Phase 13 (a) to (c) for ``cfg``: a bf16 server, a prefill of
    LM_SLOTS prompts of ``prompt_len`` tokens, ``decode_steps`` server steps
    on the prefilled cache with the launch counts zeroed just before them,
    then one more step through the kernel and through the plain version
    on copies of the cache (logits within SPREAD_TOL of the spread); with
    ``check_chunked``, layer 0's _sdpa_chunked against _sdpa_full on one
    prompt."""
    n_attn = sum(transformer.layer_kinds(cfg, l)[0] == "attn"
                 for l in range(cfg.n_layers))
    t0 = time.perf_counter()
    server, n_f32 = lm_server(dev, cfg, seed,
                              prompt_len + decode_steps + 8)
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (LM_SLOTS, prompt_len),
                            generator=g, device=dev)
    logits, prefill_s, first = prefill_into_server(server, cfg, prompts)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in server.params.parameters())
    res = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "attention_layers": n_attn, "slots": LM_SLOTS,
           "prompt_len": prompt_len, "decode_steps": decode_steps,
           "params": sum(p.numel() for p in server.params.parameters()),
           "weight_gb": weight_bytes / 1e9,
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "float32_tensors_kept": n_f32, "init_s": init_s,
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": LM_SLOTS * prompt_len / prefill_s}
    if check_chunked:
        bp = server.params.blocks[0]
        x = server.params.embed[prompts[:1]]
        q, k, v = attn_mod._project_qkv(bp.mixer, apply_norm(bp.norm1, x,
                                                             cfg),
                                        cfg, torch.bfloat16)
        at = torch.arange(prompt_len, device=dev)
        q, k = (apply_rope(t, at, cfg.rope_theta) for t in (q, k))
        chunked = attn_mod._sdpa_chunked(q, k, v, at, at, cfg)
        full = attn_mod._sdpa_full(q, k, v, at, at, cfg)
        torch.testing.assert_close(chunked.float(), full.float(),
                                   **CHUNK_TOL)
        res["chunked_vs_full_max_abs_err"] = float(
            (chunked.float() - full.float()).abs().max())
        del q, k, v, chunked, full, x
    for i in range(LM_SLOTS):
        slot = server.free[-1]
        server.submit(i, [first[slot]], decode_steps)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    step_ms = serve_steps(server, [], decode_steps)
    wall = time.perf_counter() - t0
    launches = decode_attention.launches
    other = {k: v for k, v in launch_counts().items()
             if k != "decode_attention" and v}
    if len(step_ms) != decode_steps or server.active:
        raise AssertionError(f"{cfg.name}: {len(step_ms)} steps, "
                             f"{len(server.active)} requests left")
    if launches != n_attn * decode_steps or other:
        raise AssertionError(f"{cfg.name}: decode_attention launched "
                             f"{launches} times in {decode_steps} steps of "
                             f"{n_attn} attention layers (others {other})")
    toks = np.array([r["out"] for r in server.completed])
    if toks.shape != (LM_SLOTS, decode_steps) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: completions {toks.shape}, tokens "
                             f"in [{toks.min()}, {toks.max()}]")
    res.update({"decode_wall_s": wall, "ms_per_decode_step": wall
                / decode_steps * 1e3,
                "step_ms_p50": float(np.percentile(step_ms, 50)),
                "new_tokens_per_s": LM_SLOTS * decode_steps / wall,
                "decode_attention_launches": launches,
                "decode_attention_launches_per_step": launches
                / decode_steps, "last_pos": server.pos - 1})
    # one more step, kernel against the plain version, on copies
    token = server.tokens
    step = {}
    for which in ("kernel", "plain"):
        cache = clone_cache(server.cache)
        ctx = (plain_decode_attention() if which == "plain"
               else contextlib.nullcontext())
        with ctx:
            step[which] = transformer.decode_step(
                cfg, server.params, cache, token, server.pos,
                torch.bfloat16)[0]
        del cache
    res["kernel_vs_plain_logit_err_of_spread"] = spread_err(
        step["kernel"], step["plain"], f"{cfg.name} kernel against plain")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"lm {cfg.name}: {json.dumps(res)}")
    return res, server


def rwkv_continuity(cfg, params, dev) -> float:
    """A prefill of 64 tokens, then one decode step from the state it hands
    over, against a prefill one token longer, float32 on the card (the
    reference's continuity test; in bf16 the two orders of rounding part
    ways through 32 random layers): the largest logit error, held to
    CPU_TOL."""
    g = torch.Generator(device=dev).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g, device=dev)
    _, cache = transformer.prefill(cfg, params, tokens=toks[:, :64],
                                   compute_dtype=torch.float32)
    step = transformer.decode_step(cfg, params, cache, toks[:, 64], 64,
                                   torch.float32)[0]
    longer = transformer.prefill(cfg, params, tokens=toks,
                                 compute_dtype=torch.float32)[0]
    torch.testing.assert_close(step, longer, **CPU_TOL)
    return float((step - longer).abs().max())


def int8_cache(dev) -> dict:
    """(d): qwen2-1.5b at full width (28 layers), INT8_STEPS teacher-forced
    steps of LM_SLOTS rows through an int8 cache beside a float cache,
    held to the reference's criterion every step; then a linear
    sliding-window cache (window SWA_WINDOW, a prefill padded to SWA_ROWS)
    decoded past the window, the last step's logits through the kernel's
    lower bound against the plain version.  float32 compute and a float32
    cache, as the reference's own test runs it: in bf16 the float cache's
    own rounding through 28 random layers is of the criterion's size (an
    H100 run erred 0.158 of the spread at position 0 against the bf16
    cache)."""
    cfg = get_config(ARCH)
    cd = torch.float32
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(5),
                            cd, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (INT8_STEPS, LM_SLOTS),
                           generator=g, device=dev).to(torch.int32)
    caches = {dt: lm.init_cache(cfg, LM_SLOTS, INT8_STEPS, dt, device=dev)
              for dt in (torch.int8, cd)}
    worst = 0.0
    zero_counts()
    t0 = time.perf_counter()
    for pos in range(INT8_STEPS):
        lq = transformer.decode_step(cfg, params, caches[torch.int8],
                                     tokens[pos], pos, cd)[0]
        lf = transformer.decode_step(cfg, params, caches[cd], tokens[pos],
                                     pos, cd)[0]
        worst = max(worst, spread_err(lq, lf, f"int8 cache at pos {pos}"))
    wall = time.perf_counter() - t0
    launches = decode_attention.launches
    if launches != 2 * cfg.n_layers * INT8_STEPS:
        raise AssertionError(f"int8: {launches} decode_attention launches")
    res = {"arch": cfg.name, "steps": INT8_STEPS, "slots": LM_SLOTS,
           "compute_dtype": "float32",
           "max_logit_err_of_spread": worst, "wall_s": wall,
           "decode_attention_launches": launches,
           "cache_bytes": {str(dt)[6:]: sum(t.numel() * t.element_size()
                                            for c in caches[dt]
                                            for t in c.values())
                           for dt in caches}}
    del caches
    swa = dataclasses.replace(cfg, attention="swa", swa_window=SWA_WINDOW)
    prompts = torch.randint(0, cfg.vocab_size, (LM_SLOTS, SWA_PROMPT),
                            generator=g, device=dev)
    _, cache = transformer.prefill(swa, params, tokens=prompts,
                                   compute_dtype=cd, kv_pad_to=SWA_ROWS)
    if cache[0]["k"].shape[1] != SWA_ROWS:
        raise AssertionError("the linear cache was not padded")
    zero_counts()
    for pos in range(SWA_PROMPT, SWA_PROMPT + SWA_DECODE):
        transformer.decode_step(swa, params, cache, tokens[pos], pos, cd)
    launches = decode_attention.launches
    pos = SWA_PROMPT + SWA_DECODE
    lo = pos - SWA_WINDOW + 1
    kern = transformer.decode_step(swa, params, clone_cache(cache),
                                   tokens[pos], pos, cd)[0]
    with plain_decode_attention():
        plain = transformer.decode_step(swa, params, clone_cache(cache),
                                        tokens[pos], pos, cd)[0]
    torch.testing.assert_close(kern, plain, **CPU_TOL)
    res["linear_swa"] = {
        "window": SWA_WINDOW, "rows": SWA_ROWS, "prompt": SWA_PROMPT,
        "pos": pos, "lo": lo, "decode_attention_launches": launches,
        "kernel_vs_plain_max_abs_logit_err": float(
            (kern - plain).abs().max())}
    if launches != cfg.n_layers * SWA_DECODE or lo <= 0:
        raise AssertionError(f"linear SWA: {launches} launches, lo {lo}")
    log(f"lm int8 cache and linear SWA: {json.dumps(res)}")
    return res


def lm_card_vs_cpu(dev) -> dict:
    """(e): mixtral-8x7b and rwkv6-7b at full width cut to LM_CPU_LAYERS
    layers, float32, the same weights on the card (the kernel) and the CPU
    (plain versions), LM_CPU_STEPS teacher-forced steps of LM_SLOTS rows:
    logits within CPU_TOL, as phase 8 holds qwen2; then rwkv6's prefill
    continuity on the card."""
    res = {}
    for arch in ("mixtral-8x7b", "rwkv6-7b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=LM_CPU_LAYERS)
        card = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            7), torch.float32, device=dev)
        cpu = params_from_numpy(cfg, params_to_numpy(cfg, card),
                                device="cpu")
        tokens = torch.from_numpy(np.random.RandomState(7).randint(
            0, cfg.vocab_size, (LM_CPU_STEPS, LM_SLOTS)).astype(np.int32))
        caches = {d: lm.init_cache(cfg, LM_SLOTS, LM_CPU_STEPS,
                                   torch.float32, device=d)
                  for d in (dev, "cpu")}
        err = 0.0
        t0 = time.perf_counter()
        for pos in range(LM_CPU_STEPS):
            lc = transformer.decode_step(cfg, card, caches[dev],
                                         tokens[pos].to(dev), pos,
                                         torch.float32)[0].cpu()
            lh = transformer.decode_step(cfg, cpu, caches["cpu"],
                                         tokens[pos], pos, torch.float32)[0]
            torch.testing.assert_close(lc, lh, **CPU_TOL)
            err = max(err, float((lc - lh).abs().max()))
        res[arch] = {"layers": LM_CPU_LAYERS, "steps": LM_CPU_STEPS,
                     "rows": LM_SLOTS, "max_abs_logit_err": err,
                     "s": time.perf_counter() - t0}
        if arch == "rwkv6-7b":
            res[arch]["prefill_continuity_max_abs_logit_err"] = \
                rwkv_continuity(cfg, card, dev)
        del card, cpu, caches
        free_card()
    log(f"lm card against CPU: logits within rtol=atol=1e-3; "
        f"{json.dumps(res)}")
    return res


def lm_path(dev) -> dict:
    """Phase 13: (a) mixtral-8x7b cut to MIXTRAL_LAYERS layers, (b)
    rwkv6-7b whole, (c) jamba-v0.1-52b cut to one group, (d) qwen2 with an
    int8 cache and a linear sliding-window cache, (e) card against CPU."""
    t0 = time.perf_counter()
    res = {}
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"),
                                  n_layers=MIXTRAL_LAYERS)
    res["mixtral"], server = lm_family(dev, mixtral, MIXTRAL_PROMPT,
                                       MIXTRAL_DECODE, 21,
                                       check_chunked=True)
    if server.cache[0]["k"].shape[1] != mixtral.swa_window:
        raise AssertionError("mixtral's cache is not the rolling window")
    del server
    free_card()
    res["rwkv6"], server = lm_family(dev, get_config("rwkv6-7b"),
                                     RWKV_PROMPT, RWKV_DECODE, 22)
    del server
    free_card()
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                n_layers=JAMBA_LAYERS)
    res["jamba"], server = lm_family(dev, jamba, JAMBA_PROMPT, JAMBA_DECODE,
                                     23)
    del server
    free_card()
    res["int8_cache"] = int8_cache(dev)
    free_card()
    res["card_vs_cpu"] = lm_card_vs_cpu(dev)
    res["wall_s"] = time.perf_counter() - t0
    res["decode_attention_launches"] = sum(
        res[k]["decode_attention_launches"] for k in
        ("mixtral", "rwkv6", "jamba", "int8_cache")) + res["int8_cache"][
        "linear_swa"]["decode_attention_launches"]
    log(f"lm: phase 13 in {res['wall_s']:.1f} s")
    return res


# -- phase 14 ----------------------------------------------------------------
# the training half: olmo-1b (configs/olmo_1b.py, the model the reference's
# train driver names) at full width at the reference's train_4k shape
# (configs/__init__.py: seq 4 096, global batch 256), the batch cut to 8
# (one card, a smoke run's time); float32 parameters and AdamW, bf16
# compute, remat "nothing", 2 microbatches of 4
TRAIN_ARCH = "olmo-1b"
TRAIN_SEQ, TRAIN_BATCH = SHAPES["train_4k"].seq_len, 8
TRAIN_MICRO, TRAIN_STEPS = 2, 10
#: the step time is the p50 of steps 3 to 10 (1 and 2 warm the allocator)
TRAIN_TIMED_FROM = 2
#: card against CPU, float32, TRAIN_CPU_STEPS steps from one state at
#: batch 2 and seq 32: the loss and the grad norm at rtol TRAIN_RTOL; mu
#: and nu at rtol TRAIN_RTOL with an atol of TRAIN_RTOL of the tree's
#: largest magnitude, as tests/test_torch_train.py holds the CPU to the
#: JAX package; the parameters at rtol = atol = TRAIN_RTOL, but for the
#: entries whose mu on the CPU lies within TRAIN_RTOL of its array's
#: largest of 0 after the step (and is not exactly 0 on both sides): the
#: sign of their gradient is rounding, and AdamW's normalised step (about
#: lr * sign(g) early on) may then move them apart by up to 2 * TRAIN_LR
TRAIN_LR = 3e-4
TRAIN_CPU_ARCHS = ("olmo-1b", "mixtral-8x7b", "jamba-v0.1-52b")
TRAIN_CPU_B, TRAIN_CPU_S, TRAIN_CPU_STEPS = 2, 32, 2
TRAIN_RTOL = 1e-4
#: resume: RESUME_STEPS straight against half, a save, a fresh state and
#: the other half (tests/test_sinks_and_ft_extras.py's rel 1e-4)
RESUME_STEPS = 6


def train_full(dev) -> dict:
    """(a): TRAIN_STEPS steps of olmo-1b at full width from
    ``launch/train.py``'s step builder on ``SyntheticLMData``: every loss
    and grad norm finite, the last loss below the first; ms a step, tokens
    a second, peak memory, model FLOPs a step and their share of the
    card's bf16 dense peak."""
    free_card()
    # the peak over what earlier phases still hold (phase 7's weights)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    state, step_fn = train_mod.make_trainer(
        cfg, steps=TRAIN_STEPS, compute_dtype=torch.bfloat16,
        microbatches=TRAIN_MICRO, remat_policy="nothing", seed=0, device=dev)
    n_params = sum(p.numel() for p in state["params"].parameters())
    data = SyntheticLMData(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    metrics, step_ms = [], []
    zero_counts()
    for step in range(TRAIN_STEPS):
        batch = train_mod.batch_on(data.batch_at(step), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = launch_counts()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"train: non-finite loss or grad norm: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if int(state["step"]) != TRAIN_STEPS:
        raise AssertionError(f"train: step {int(state['step'])}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = float(np.percentile(step_ms[TRAIN_TIMED_FROM:], 50))
    # 6 N a token for the products with the weights (the tied head
    # included), and the attention's two S x S products, forward and
    # backward, at the full S x S the path computes (it masks, it does not
    # skip); the remat recompute is not model work
    flops = (6 * n_params * tokens + 12 * TRAIN_BATCH * TRAIN_SEQ ** 2
             * cfg.n_heads * cfg.head_dim_ * cfg.n_layers)
    res = {"arch": TRAIN_ARCH, "params": n_params, "seq": TRAIN_SEQ,
           "batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO,
           "remat_policy": "nothing", "steps": TRAIN_STEPS,
           "step_ms": step_ms, "step_ms_p50": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - held,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "grad_norms": norms,
           "model_flops_per_step": flops,
           "bf16_peak_share": flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "launches": launches}
    log(f"train olmo-1b full width, seq {TRAIN_SEQ} batch {TRAIN_BATCH} "
        f"({TRAIN_MICRO} microbatches): {ms:.1f} ms a step (p50 of steps "
        f"{TRAIN_TIMED_FROM + 1}-{TRAIN_STEPS}), "
        f"{res['tokens_per_s']:.0f} tokens/s, peak "
        f"{res['peak_memory_bytes'] / 1e9:.2f} GB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, grad norm {norms[0]:.3f} -> {norms[-1]:.3f}, "
        f"{flops / 1e12:.1f} TFLOP a step, {res['bf16_peak_share']:.4f} of "
        f"the bf16 dense peak")
    del state, step_fn, metrics
    free_card()
    return res


def _np_leaves(t) -> list:
    """The arrays of a numpy tree (dicts by sorted key, tuples in order)."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _np_leaves(t[k])]
    if isinstance(t, tuple):
        return [x for v in t for x in _np_leaves(v)]
    return [np.asarray(t, np.float64)]


def _tree_violation(got, want, atol=None) -> float:
    """The largest ``|got - want| / (atol + TRAIN_RTOL |want|)`` over two
    numpy trees of one structure (below 1: within tolerance); ``atol``
    defaults to TRAIN_RTOL of the tree's largest magnitude."""
    g, w = _np_leaves(got), _np_leaves(want)
    if len(g) != len(w) or any(a.shape != b.shape for a, b in zip(g, w)):
        raise AssertionError("train: trees of different structure")
    if atol is None:
        atol = TRAIN_RTOL * max(float(np.abs(b).max()) for b in w if b.size)
    if atol == 0:
        return max(float((a != b).any()) for a, b in zip(g, w))
    return max(float((np.abs(a - b) / (atol + TRAIN_RTOL * np.abs(b))).max())
               for a, b in zip(g, w) if b.size)


@torch.no_grad()
def copy_train_state_(dst: dict, src: dict) -> None:
    """Every tensor of the train state ``src`` into ``dst``'s, in place."""
    for name, p in dst["params"].named_parameters():
        p.copy_(src["params"].get_parameter(name))
    for k in ("mu", "nu"):
        for name, t in dst["opt"][k].items():
            t.copy_(src["opt"][k][name])
    dst["opt"]["count"].copy_(src["opt"]["count"])
    dst["step"].copy_(src["step"])


def train_card_vs_cpu(dev) -> dict:
    """(b): reduced olmo-1b, mixtral-8x7b (MoE aux, the index_put_
    backward) and jamba (the Mamba scan's backward), float32,
    TRAIN_CPU_STEPS steps on the card and on the CPU, each from one state
    (the card takes the CPU's state after each comparison, so a comparison
    sees one step's rounding, not AdamW's amplification of the step
    before): the loss, the grad norm, every parameter, mu and nu within
    TRAIN_RTOL (see there)."""
    res = {}
    for arch in TRAIN_CPU_ARCHS:
        cfg = get_config(arch).reduced()
        cpu, step_fn = train_mod.make_trainer(
            cfg, steps=10, lr=TRAIN_LR, compute_dtype=torch.float32, seed=9,
            device="cpu")
        card = {"params": params_from_numpy(
                    cfg, params_to_numpy(cfg, cpu["params"]), dev),
                "opt": opt_state_from_numpy(
                    cfg, opt_state_to_numpy(cfg, cpu["opt"]), dev),
                "step": cpu["step"].clone().to(dev)}
        data = SyntheticLMData(cfg.vocab_size, TRAIN_CPU_B, TRAIN_CPU_S,
                               seed=9)
        worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0, "mu": 0.0,
                 "nu": 0.0}
        free = 0
        for step in range(TRAIN_CPU_STEPS):
            batch = data.batch_at(step)
            card, mc = step_fn(card, train_mod.batch_on(batch, dev))
            cpu, mh = step_fn(cpu, train_mod.batch_on(batch, "cpu"))
            for k in ("loss", "grad_norm"):
                a, b = float(mc[k]), float(mh[k])
                worst[k] = max(worst[k], abs(a - b) / (TRAIN_RTOL * abs(b)))
            oc = opt_state_to_numpy(cfg, card["opt"])
            oh = opt_state_to_numpy(cfg, cpu["opt"])
            for k in ("mu", "nu"):
                worst[k] = max(worst[k], _tree_violation(oc[k], oh[k]))
            mu, mu_card = _np_leaves(oh["mu"]), _np_leaves(oc["mu"])
            # within TRAIN_RTOL of the array's largest of 0, but for exact
            # zeros on both sides (no gradient: an expert no token chose)
            near0 = [(np.abs(m) <= TRAIN_RTOL * np.abs(m).max())
                     & ((m != 0) | (c != 0)) for m, c in zip(mu, mu_card)]
            free += sum(int(n.sum()) for n in near0)
            for a, b, f in zip(_np_leaves(params_to_numpy(cfg, card["params"])),
                               _np_leaves(params_to_numpy(cfg, cpu["params"])),
                               near0):
                tol = np.where(f, 2 * TRAIN_LR, TRAIN_RTOL) \
                    + TRAIN_RTOL * np.abs(b)
                worst["params"] = max(worst["params"],
                                      float((np.abs(a - b) / tol).max()))
            if {int(card["step"]), int(cpu["step"])} != {step + 1}:
                raise AssertionError(f"train {arch}: step counts differ")
            copy_train_state_(card, cpu)
        if not all(v < 1 for v in worst.values()):
            raise AssertionError(f"train {arch}: card against CPU beyond "
                                 f"tolerance (ratio to it): {worst}")
        res[arch] = {"tolerance_ratio": worst, "loss": float(mc["loss"]),
                     "sign_free_entries": free,
                     "entries": TRAIN_CPU_STEPS * sum(
                         p.numel() for p in cpu["params"].parameters())}
        del card, cpu
        free_card()
    log(f"train card against CPU, float32, {TRAIN_CPU_STEPS} steps, within "
        f"rtol {TRAIN_RTOL} (largest error over tolerance): {json.dumps(res)}")
    return res


def train_resume(dev) -> dict:
    """(c): ``launch.train.main`` on the card, reduced olmo-1b:
    RESUME_STEPS straight steps against half of them, an async save, a
    fresh state and the rest with ``--resume`` (last losses within rel
    1e-4); then an async save followed at once by a step, and a restore:
    the state at the save, exactly."""
    res = {}
    half = RESUME_STEPS // 2
    with tempfile.TemporaryDirectory(prefix="train-") as tmp:
        common = ["--arch", TRAIN_ARCH, "--reduced", "--batch", "2",
                  "--seq", "32", "--device", str(dev)]
        straight = train_mod.main(common + [
            "--steps", str(RESUME_STEPS), "--log-every", str(RESUME_STEPS),
            "--ckpt-dir", f"{tmp}/a", "--ckpt-every", "100"])
        train_mod.main(common + [
            "--steps", str(half), "--schedule-steps", str(RESUME_STEPS),
            "--log-every", str(half), "--ckpt-dir", f"{tmp}/b",
            "--ckpt-every", str(half)])
        resumed = train_mod.main(common + [
            "--steps", str(RESUME_STEPS), "--log-every", str(RESUME_STEPS),
            "--ckpt-dir", f"{tmp}/b", "--ckpt-every", "100", "--resume"])
        rel = abs(straight[-1] - resumed[-1]) / abs(straight[-1])
        if not rel <= 1e-4:
            raise AssertionError(f"train resume: {straight} against "
                                 f"{resumed}")
        res["resume"] = {"straight": straight[-1], "resumed": resumed[-1],
                         "rel": rel}

        cfg = get_config(TRAIN_ARCH).reduced()
        state, step_fn = train_mod.make_trainer(
            cfg, steps=10, compute_dtype=torch.float32, device=dev)
        data = SyntheticLMData(cfg.vocab_size, 2, 32)
        state, _ = step_fn(state, train_mod.batch_on(data.batch_at(0), dev))
        at_save = (params_to_numpy(cfg, state["params"]),
                   opt_state_to_numpy(cfg, state["opt"]))
        mgr = CheckpointManager(f"{tmp}/c", async_save=True)
        mgr.save(state, 1)
        state, _ = step_fn(state, train_mod.batch_on(data.batch_at(1), dev))
        mgr.wait()
        fresh, _ = train_mod.make_trainer(
            cfg, steps=10, compute_dtype=torch.float32, seed=1, device=dev)
        restored = mgr.restore(fresh)
        got = (params_to_numpy(cfg, restored["params"]),
               opt_state_to_numpy(cfg, restored["opt"]))
        if _tree_violation(got, at_save, atol=0) or \
                int(restored["step"]) != 1:
            raise AssertionError("train: the async save did not restore the "
                                 "state at the save")
        res["async_save_exact"] = True
    log(f"train resume on the card: {json.dumps(res)}")
    return res


def train_path(dev) -> dict:
    """Phase 14: (a) olmo-1b at full width, (b) card against CPU, (c)
    resume and the async save."""
    t0 = time.perf_counter()
    res = {"full_width": train_full(dev)}
    res["card_vs_cpu"] = train_card_vs_cpu(dev)
    res["resume"] = train_resume(dev)
    res["wall_s"] = time.perf_counter() - t0
    log(f"train: phase 14 in {res['wall_s']:.1f} s")
    return res


# -- phase 15 ----------------------------------------------------------------
# the mesh layer: 4 ranks spawned as phase 9 spawns them (NCCL with a card a
# rank where the host has 4 cards, else gloo with the ranks sharing this
# card); parameters, AdamW's moments and batches are DTensors placed by
# sharding/rules.py
MESH_RANKS = 4
#: (a) olmo-1b at full width through launch/train.py's trainer on 2x2, in
#: the reference driver's configuration, train_4k's sequence cut from
#: 4 096 to 2 048 (four processes share one card's 80 GB)
MESH_SEQ, MESH_BATCH, MESH_MICRO, MESH_STEPS = 2048, 8, 2, 5
#: the step time is the p50 of steps 2 to 5; step 1 (DTensor's sharding
#: propagation warms its caches) runs under the collective counter
MESH_TIMED_FROM = 1
#: (b) exactness on the card: 2 layers at full width, float32, against the
#: one-process port on the same card (phase 14's card tolerance)
MESH_TOL = 1e-4
MESH_EXACT_LAYERS, MESH_EXACT_B, MESH_EXACT_S = 2, 4, 128
#: (c) mixtral-8x7b expert-parallel at full width: 4 of 32 layers in bf16
#: on 1x4 (E = 8: 2 experts a rank), a forward of 8 x 512 tokens
MESH_MOE_LAYERS, MESH_MOE_B, MESH_MOE_S = 4, 8, 512
#: (d) tests/test_dryrun_multipod.py's cells, dry-run on the host
MESH_DRYRUN_CELLS = (("olmo-1b", "train_4k", True),
                     ("qwen2-1.5b", "decode_32k", True),
                     ("rwkv6-7b", "long_500k", False))
MESH_SEED = 3


def mesh_dryrun_start() -> list:
    """(d): the three cells' dry runs, each a process of its own on the
    host (no card: ``CUDA_VISIBLE_DEVICES`` empty), started at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, mp in MESH_DRYRUN_CELLS:
        log_file = tempfile.TemporaryFile(mode="w+", prefix="dryrun-")
        procs.append(((arch, shape, mp), log_file, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape] + (["--multi-pod"] if mp else []),
            env=env, cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)))
    return procs


def mesh_dryrun_finish(procs: list, timeout_s: float = 600) -> dict:
    """(d)'s results: argument and peak GB a device and ``fits_80gb``
    of each cell; a cell that failed or does not fit fails the phase."""
    res = {}
    try:
        for (arch, shape, mp), log_file, proc in procs:
            rc = proc.wait(timeout=timeout_s)
            log_file.seek(0)
            text = log_file.read()
            if rc != 0:
                raise AssertionError(f"dry run {arch}/{shape}: exit {rc}: "
                                     f"{text[-2000:]}")
            mesh = "2x16x16" if mp else "16x16"
            r = json.loads((ROOT / "experiments" / "dryrun_torch" /
                            f"{arch}__{shape}__{mesh}.json").read_text())
            res[f"{arch}/{shape}/{mesh}"] = {
                "argument_gb": r["memory"]["argument_bytes"] / 1e9,
                "peak_gb": r["memory"]["peak_bytes"] / 1e9,
                "fits_80gb": r["fits_80gb"], "flops": r["flops"],
                "collective_bytes": r["collectives"]["total_bytes"],
                "step_s": r["step_s"]}
            if not r["fits_80gb"]:
                raise AssertionError(f"dry run {arch}/{shape}/{mesh} does "
                                     f"not fit 80 GB: {res}")
    finally:
        for _, log_file, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()
    for cell, r in res.items():
        log(f"mesh (d) dry run {cell}: argument {r['argument_gb']:.3f} GB "
            f"and peak {r['peak_gb']:.3f} GB a device, fits_80gb "
            f"{r['fits_80gb']}, {r['flops']:.3e} FLOP a device, "
            f"{r['collective_bytes'] / 1e9:.3f} GB to collectives, "
            f"{r['step_s']} s")
    return res


def mesh_cfg(arch: str, layers: int):
    return dataclasses.replace(get_config(arch), n_layers=layers)


def mesh_exact_batch(cfg, dev, mesh=None):
    return train_mod.batch_on(SyntheticLMData(
        cfg.vocab_size, MESH_EXACT_B, MESH_EXACT_S,
        seed=MESH_SEED).batch_at(0), dev, mesh)


@contextlib.contextmanager
def captured_routing(out: list):
    """Within the block, the first ``moe._route`` call's experts and kept
    choices are appended to ``out`` (layer 0's routing)."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod._route

    def recording(*args):
        r = route(*args)
        if not out:
            out.append((r[2].detach().cpu().numpy().copy(),
                        r[4].detach().cpu().numpy().copy()))
        return r

    moe_mod._route = recording
    try:
        yield
    finally:
        moe_mod._route = route


def mesh_train_timed(dev, mesh=None) -> dict:
    """(a)'s run: olmo-1b at full width, MESH_STEPS steps from
    ``launch/train.py``'s trainer (on ``mesh`` where given), step 1 under
    the collective counter; ms a step, tokens/s and peak memory."""
    from repro_torch.launch.dryrun import CollectiveCounter
    free_card()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = get_config(TRAIN_ARCH)
    state, step_fn = train_mod.make_trainer(
        cfg, steps=MESH_STEPS, compute_dtype=torch.bfloat16,
        microbatches=MESH_MICRO, seed=0, device=dev, mesh=mesh)
    data = SyntheticLMData(cfg.vocab_size, MESH_BATCH, MESH_SEQ, seed=0)
    losses, norms, step_ms = [], [], []
    comms = None
    for step in range(MESH_STEPS):
        batch = train_mod.batch_on(data.batch_at(step), dev, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == 0 and mesh is not None:
            with CollectiveCounter() as counter:
                state, m = step_fn(state, batch)
            comms = counter.summary()
        else:
            state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(train_mod.value(m["loss"]))
        norms.append(train_mod.value(m["grad_norm"]))
    ms = float(np.percentile(step_ms[MESH_TIMED_FROM:], 50))
    res = {"step_ms": step_ms, "step_ms_p50": ms,
           "tokens_per_s": MESH_BATCH * MESH_SEQ / (ms / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - held,
           "losses": losses, "grad_norms": norms, "collectives": comms}
    del state, step_fn
    free_card()
    return res


def mesh_references(dev, path: Path) -> dict:
    """The one-process port on this card: (a) at (a)'s shape, (b)'s olmo
    step and mixtral loss (with layer 0's routing); (b)'s numbers go to
    ``path`` for the ranks."""
    res = {"olmo_full": mesh_train_timed(dev)}
    cfg = mesh_cfg(TRAIN_ARCH, MESH_EXACT_LAYERS)
    state, step_fn = train_mod.make_trainer(
        cfg, steps=10, compute_dtype=torch.float32, seed=MESH_SEED,
        device=dev)
    state, m = step_fn(state, mesh_exact_batch(cfg, dev))
    arrays = {"olmo/loss": np.float64(float(m["loss"])),
              "olmo/grad_norm": np.float64(float(m["grad_norm"]))}
    for name, p in state["params"].named_parameters():
        arrays[f"olmo/params/{name}"] = p.detach().cpu().numpy()
    del state, step_fn
    free_card()
    cfg = mesh_cfg("mixtral-8x7b", MESH_EXACT_LAYERS)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_SEED), torch.float32, device=dev)
    routing = []
    with torch.no_grad(), captured_routing(routing):
        loss, _ = lm.loss_fn(cfg, params, mesh_exact_batch(cfg, dev),
                             torch.float32)
    arrays["mixtral/loss"] = np.float64(float(loss))
    arrays["mixtral/experts"], arrays["mixtral/kept"] = routing[0]
    del params
    free_card()
    np.savez(path, **arrays)
    return res


def mesh_violation(got: float, want) -> float:
    """``|got - want| / (MESH_TOL (1 + |want|))``, largest over arrays."""
    want = np.asarray(want, np.float64)
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / (MESH_TOL * (1 + np.abs(want)))).max())


def mesh_exact(rank: int, dev, ref: dict) -> dict:
    """(b) on this rank: olmo's step on 2x2 and 1x4, mixtral's loss and
    routing on 1x4, against the one-process port's (``ref``); rank 0
    compares, every rank gathers."""
    res = {}
    cfg = mesh_cfg(TRAIN_ARCH, MESH_EXACT_LAYERS)
    for shape in ((2, 2), (1, 4)):
        mesh = make_smoke_mesh(shape, ("data", "model"), "cuda")
        constraints.set_mesh(mesh)
        try:
            state, step_fn = train_mod.make_trainer(
                cfg, steps=10, compute_dtype=torch.float32, seed=MESH_SEED,
                device=dev, mesh=mesh)
            state, m = step_fn(state, mesh_exact_batch(cfg, dev, mesh))
            worst = {"loss": mesh_violation(train_mod.value(m["loss"]),
                                            ref["olmo/loss"]),
                     "grad_norm": mesh_violation(
                         train_mod.value(m["grad_norm"]),
                         ref["olmo/grad_norm"]), "params": 0.0}
            for name, p in state["params"].named_parameters():
                whole = p.full_tensor().detach().cpu().numpy()
                worst["params"] = max(worst["params"], mesh_violation(
                    whole, ref[f"olmo/params/{name}"]))
        finally:
            constraints.set_mesh(None)
        res[f"olmo_{shape[0]}x{shape[1]}"] = worst
        del state, step_fn
        free_card()
    mesh = make_smoke_mesh((1, 4), ("data", "model"), "cuda")
    cfg = mesh_cfg("mixtral-8x7b", MESH_EXACT_LAYERS)
    constraints.set_mesh(mesh)
    try:
        # the whole experts are built one rank at a time: 11.3 GB each
        for r in range(dist.get_world_size()):
            if r == rank:
                params = lm.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(MESH_SEED),
                    torch.float32, device=dev)
                rules.distribute_module(params, mesh,
                                        rules.param_sharding(mesh, params))
                free_card()
            dist.barrier()
        routing = []
        with torch.no_grad(), captured_routing(routing), \
                constraints.replicated_constants():
            loss, _ = lm.loss_fn(cfg, params,
                                 mesh_exact_batch(cfg, dev, mesh),
                                 torch.float32)
        res["mixtral_1x4"] = {
            "loss": mesh_violation(train_mod.value(loss),
                                   ref["mixtral/loss"]),
            "routing_exact": bool(
                np.array_equal(routing[0][0], ref["mixtral/experts"])
                and np.array_equal(routing[0][1], ref["mixtral/kept"]))}
    finally:
        constraints.set_mesh(None)
    del params
    free_card()
    return res


def mesh_moe_forward(rank: int, dev) -> dict:
    """(c) on this rank: mixtral-8x7b, MESH_MOE_LAYERS layers in bf16 on
    1x4 (expert-parallel: 2 experts a rank), a forward of MESH_MOE_B x
    MESH_MOE_S tokens: ms (p50 of 3 after a warm-up), peak memory, and
    the bytes ``all_reduce`` moves a layer."""
    from repro_torch.launch.dryrun import CollectiveCounter
    mesh = make_smoke_mesh((1, 4), ("data", "model"), "cuda")
    cfg = mesh_cfg("mixtral-8x7b", MESH_MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    for r in range(dist.get_world_size()):
        if r == rank:
            params = lm.init_params(
                cfg, torch.Generator(device=dev).manual_seed(MESH_SEED),
                torch.bfloat16, device=dev)
            rules.distribute_module(
                params, mesh, rules.param_sharding(mesh, params, fsdp=False))
            free_card()
        dist.barrier()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tokens = train_mod.batch_on(SyntheticLMData(
        cfg.vocab_size, MESH_MOE_B, MESH_MOE_S, seed=MESH_SEED).batch_at(0),
        dev, mesh)["tokens"]
    constraints.set_mesh(mesh)
    times = []
    try:
        with torch.no_grad():
            with CollectiveCounter() as counter:
                logits, _ = transformer.forward(cfg, params, tokens=tokens,
                                                compute_dtype=torch.bfloat16)
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = transformer.forward(cfg, params, tokens=tokens,
                                                compute_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        finite = bool(torch.isfinite(logits.to_local()).all())
    finally:
        constraints.set_mesh(None)
    comms = counter.summary()
    res = {"ms": float(np.median(times)), "times_ms": times,
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - held,
           "params_bytes": held, "finite": finite,
           "logits_local_shape": list(logits.to_local().shape),
           "all_reduce_bytes_per_layer":
               comms["bytes"].get("all_reduce", 0) / MESH_MOE_LAYERS,
           "collectives": comms}
    del params, logits
    free_card()
    return res


def mesh_rank(rank: int, world: int, dev, ref_path: str) -> dict:
    """Phase 15 in one rank: (a) on 2x2, (b), (c)."""
    zero_counts()
    ref = dict(np.load(ref_path))
    mesh = make_smoke_mesh((2, 2), ("data", "model"), "cuda")
    constraints.set_mesh(mesh)
    try:
        train = mesh_train_timed(dev, mesh)
    finally:
        constraints.set_mesh(None)
    exact = mesh_exact(rank, dev, ref)
    moe_fwd = mesh_moe_forward(rank, dev)
    return {"train": train, "exact": exact, "moe_forward": moe_fwd,
            "launches": launch_counts()}


def mesh_path(dev, trains=None) -> dict:
    """Phase 15: (a) olmo-1b at full width on ``train --mesh 2x2``, beside
    one process at the same shape (and phase 14's run where it ran); (b)
    the sharded runs against the one-process port; (c) mixtral's
    expert-parallel forward; (d) the dry run's three cells."""
    t0 = time.perf_counter()
    dry = mesh_dryrun_start()
    cards = torch.cuda.device_count()
    backend = ranks_backend(torch.device("cuda"), MESH_RANKS)
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        ref_path = Path(tmp) / "ref.npz"
        one = mesh_references(dev, ref_path)
        log(f"mesh: {MESH_RANKS} ranks over {backend} "
            f"({cards} card(s)); one process first")
        per_rank = spawn_ranks(mesh_rank, MESH_RANKS, backend=backend,
                               device="cuda", args=(str(ref_path),),
                               timeout_s=900)
    res = {"ranks": MESH_RANKS, "backend": backend,
           "one_process": one["olmo_full"],
           "per_rank": per_rank, "dryrun": mesh_dryrun_finish(dry)}
    base = one["olmo_full"]
    log(f"mesh (a) one process, olmo-1b full width seq {MESH_SEQ} batch "
        f"{MESH_BATCH} ({MESH_MICRO} microbatches): {base['step_ms_p50']:.1f}"
        f" ms a step, {base['tokens_per_s']:.0f} tokens/s, peak "
        f"{base['peak_memory_bytes'] / 1e9:.2f} GB, loss "
        f"{base['losses'][0]:.4f} -> {base['losses'][-1]:.4f}")
    if trains is not None:
        full = trains["full_width"]
        log(f"mesh (a) phase 14 beside it (seq {TRAIN_SEQ}, one process): "
            f"{full['step_ms_p50']:.1f} ms a step, "
            f"{full['tokens_per_s']:.0f} tokens/s, peak "
            f"{full['peak_memory_bytes'] / 1e9:.2f} GB")
    for rank, r in enumerate(per_rank):
        t = r["train"]
        log(f"mesh (a) rank {rank} on 2x2: {t['step_ms_p50']:.1f} ms a step "
            f"(p50 of steps {MESH_TIMED_FROM + 1}-{MESH_STEPS}), "
            f"{t['tokens_per_s']:.0f} tokens/s, peak "
            f"{t['peak_memory_bytes'] / 1e9:.2f} GB, loss "
            f"{t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}; one step's "
            f"collectives {json.dumps(t['collectives'])}")
        m = r["moe_forward"]
        log(f"mesh (c) rank {rank}: mixtral {MESH_MOE_LAYERS} layers bf16 "
            f"1x4 forward of {MESH_MOE_B} x {MESH_MOE_S}: {m['ms']:.1f} ms, "
            f"peak {m['peak_memory_bytes'] / 1e9:.2f} GB over "
            f"{m['params_bytes'] / 1e9:.2f} GB of its shards, all_reduce "
            f"{m['all_reduce_bytes_per_layer'] / 1e6:.2f} MB a layer")
    for r in per_rank:
        losses = r["train"]["losses"] + r["train"]["grad_norms"]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"mesh (a): non-finite loss: {losses}")
        if not r["train"]["losses"][-1] < r["train"]["losses"][0]:
            raise AssertionError(f"mesh (a): the loss did not fall: "
                                 f"{r['train']['losses']}")
        if not r["moe_forward"]["finite"]:
            raise AssertionError("mesh (c): non-finite logits")
        if any(r["launches"].values()):
            raise AssertionError(f"mesh: kernels launched {r['launches']}")
    exact = per_rank[0]["exact"]
    log(f"mesh (b) sharded against one process on the card, largest error "
        f"over the {MESH_TOL} tolerance: {json.dumps(exact)}")
    ratios = [v for case in exact.values() for k, v in case.items()
              if k != "routing_exact"]
    if not all(v < 1 for v in ratios) or \
            not exact["mixtral_1x4"]["routing_exact"]:
        raise AssertionError(f"mesh (b): beyond tolerance: {exact}")
    res["launches"] = {k: sum(r["launches"][k] for r in per_rank)
                       for k in per_rank[0]["launches"]}
    res["wall_s"] = time.perf_counter() - t0
    log(f"mesh: phase 15 in {res['wall_s']:.1f} s")
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
    beside the plain version, after one call of each from the same state
    has come out equal in every entry, by CUDA events
    over 200 back-to-back calls in turns, then device time alone
    (profiler); and its bound: ts, key, value and valid read once,
    slot_frame read once, every pane cell the batch touches read and
    written once, at 3.35 TB/s.  No single PyTorch call computes
    accumulate, so there is no library yardstick."""
    rng = np.random.RandomState(11)
    b = q5_batch(NexmarkGenerator(rate=RATE, n_keys=N_AUCTIONS), 7)
    ts, key, value, valid = (torch.from_numpy(b[k]).to(dev)
                             for k in ("ts", "key", "value", "valid"))
    # the state after 7 steps: the first window (end 10 ms) emitted
    base = window_state_init(SPEC, device="cpu")
    base["slot_frame"][:7] = torch.arange(7, dtype=torch.int32)
    base["panes"][:7] = torch.from_numpy(
        rng.randint(0, 3, (7, K)).astype(np.float32))
    base["next_emit"].fill_(10)
    base["watermark"].fill_(7 * SLIDE_MS - 1)
    states = {w: {k: v.to(dev, copy=True) for k, v in base.items()}
              for w in ("kernel", "plain")}
    kw = dict(slide_ms=SPEC.slide_ms, frames_per_window=SPEC.frames_per_window,
              wm_lag=SPEC.wm_lag, frontier_from_data=SPEC.frontier_from_data)
    # one call of each from the same state: Q5 counts are integers, so
    # every entry, panes included, must come out equal
    got = accumulate_({k: v.to(dev, copy=True) for k, v in base.items()},
                      ts, key, value, valid, **kw)
    want = accumulate_plain_({k: v.to(dev, copy=True)
                              for k, v in base.items()},
                             ts, key, value, valid, **kw)
    for k in base:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"accumulate differs from the plain version "
                                 f"on {k}")
    max_abs_err = float((got["panes"] - want["panes"]).abs().max())
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
           "max_abs_err": max_abs_err,
           "device_ms": dev_only["kernel"],
           "plain_device_ms": dev_only["plain"],
           "events_ms": times}
    log(f"accumulate timing at N={n} K={K} R={SPEC.ring_len} "
        f"({int(valid.sum())} bids, {cells} cells): {json.dumps(res)}")
    return res


def emit_kw(spec) -> dict:
    return dict(slide_ms=spec.slide_ms,
                frames_per_window=spec.frames_per_window,
                max_windows_per_step=spec.max_windows_per_step,
                buffer_rows=spec.emit_buffer_rows)


def time_emit(dev) -> tuple[dict, dict]:
    """The emit kernel at a catch-up Q5 step (the benchmark's: the paper's
    ring full with frames 0..1 007, 8 windows due, each retiring a frame)
    beside the plain version on the card and its library yardstick (the
    round's (8, 1 008) masks @ the panes by ``torch.matmul``, the masks
    made ahead), by CUDA events over 200 calls in turns.  Every call starts
    from the same front and slot frames (two small copies, in each of the
    first two); the evicted rows stay zero.  The kernel is held against
    the plain version first, whole state and outputs.  Its bound: the pane
    rows the windows read, read once, the (EB, K) result buffer and the
    evicted rows written once, at 3.35 TB/s.  Returns the timings and the
    three calls, for device time alone (profiler) later."""
    rng = np.random.RandomState(13)
    F, R, EB = SPEC.frames_per_window, SPEC.ring_len, SPEC.emit_buffer_rows
    state = window_state_init(SPEC, device=dev)
    state["slot_frame"].copy_(torch.arange(R, dtype=torch.int32))
    state["panes"].copy_(torch.from_numpy(
        rng.randint(0, 3, (R, K)).astype(np.float32)))
    state["next_emit"].fill_(F * SLIDE_MS)
    state["watermark"].fill_(R * SLIDE_MS - 1)
    kw = emit_kw(SPEC)
    want = {k: v.clone() for k, v in state.items()}
    got = {k: v.clone() for k, v in state.items()}
    _, out = emit_(got, **kw)
    _, ref = emit_plain_(want, **kw)
    if (out["rows"], out["rounds"], out["host_syncs"]) != (8, 1, 1) or \
            (ref["rows"], ref["rounds"]) != (8, 1) or any(
                not torch.equal(out[k], ref[k])
                for k in ("results", "window_ends", "valid")) or any(
                not torch.equal(got[k], want[k]) for k in state):
        raise AssertionError("emit timing: the kernel and the plain version "
                             "disagree at the Q5 step")
    front, frames = state["next_emit"].clone(), state["slot_frame"].clone()
    states = {w: {k: v.clone() for k, v in state.items()}
              for w in ("kernel", "plain")}

    def call(which, fn):
        st = states[which]
        st["next_emit"].copy_(front)
        st["slot_frame"].copy_(frames)
        return fn(st, **kw)

    L = np.arange(F - 1, F + 7)                      # the 8 windows' frames
    f = np.arange(R)
    masks = torch.from_numpy(((f[None, :] > (L - F)[:, None])
                              & (f[None, :] <= L[:, None])).astype(
        np.float32)).to(dev)
    fns = {"kernel": lambda: call("kernel", emit_),
           "plain": lambda: call("plain", emit_plain_),
           "library": lambda: masks @ state["panes"]}
    with ieee_fp32_matmul():
        if not torch.equal(fns["library"](), ref["results"][:8]):
            raise AssertionError("emit timing: the library yardstick "
                                 "disagrees")
        times = {}
        for label in ("plain", "kernel", "library", "kernel", "plain"):
            times.setdefault(label, []).append(cuda_ms(fns[label],
                                                       iters=200))
    read_rows = int(masks.amax(0).sum())
    bytes_moved = (read_rows + EB + 8) * K * 4 + R * 4 + EB * 5
    res = {"ms": min(times["kernel"]), "plain_ms": min(times["plain"]),
           "library_ms": min(times["library"]),
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes": bytes_moved, "events_ms": times}
    log(f"emit timing at K={K} R={R} EB={EB} (8 windows, {read_rows} pane "
        f"rows): {json.dumps(res)}")
    return res, fns


def profile_emit(fns: dict, entry: dict) -> None:
    """Device time alone (profiler) of emit's three timed calls: the
    kernel's and the plain version's include their two small copies."""
    with ieee_fp32_matmul():
        dev_only = {label: device_ms(fn) for label, fn in fns.items()}
    entry.update({"device_ms": dev_only["kernel"],
                  "plain_device_ms": dev_only["plain"],
                  "library_device_ms": dev_only["library"]})
    log(f"emit device time (profiler) ms {json.dumps(dev_only)}")


def new_kernel_resources(dev) -> dict:
    """Registers, spills and shared memory (ptxas) of the fused accumulate,
    of emit and of route_pack, and route_pack's cluster at the path's plan: blocks,
    threads, claims a block and clusters the card holds at once."""
    plan = pack_plan(B // RANKS, RANKS, max(8, int(B // RANKS / RANKS * 2.0)))
    blocks, threads, clusters = pack_cluster(plan.cells_per_block,
                                             dev.index or 0)
    res = {"accumulate_ptxas": ptxas_report("window_agg",
                                            "accumulate_kernel"),
           "emit_ptxas": ptxas_report("window_agg", "emit_kernel"),
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


def profile_train(dev, wall_ms_per_step: float) -> dict:
    """Where a full-width train step's time goes: phase 14 (a)'s step
    (olmo-1b, seq 4 096, batch 8 in 2 microbatches) profiled once, device
    time by kernel against the unprofiled run's p50 wall time a step; the
    products' device time split into IEEE f32 products on CUDA cores
    (cuBLAS's ``f32f32`` and CUTLASS's ``sgemm`` kernels: the attention's
    S x S products of f32 scores) and the rest (the bf16 products, cuBLAS's
    ``nvjet`` kernels on Hopper)."""
    free_card()
    cfg = get_config(TRAIN_ARCH)
    state, step_fn = train_mod.make_trainer(
        cfg, steps=TRAIN_STEPS, compute_dtype=torch.bfloat16,
        microbatches=TRAIN_MICRO, remat_policy="nothing", seed=0, device=dev)
    batch = train_mod.batch_on(SyntheticLMData(
        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0), dev)
    kernels = profiled(lambda: step_fn(state, batch), iters=1)
    busy = sum(ms for ms, _ in kernels.values())
    gemm = {"f32": 0.0, "other": 0.0}
    for name, (ms, _) in kernels.items():
        low = name.lower()
        if "f32f32" in low or "sgemm" in low:
            gemm["f32"] += ms
        elif "gemm" in low or "nvjet" in low or "xmma" in low:
            gemm["other"] += ms
    res = {"wall_ms_per_step": wall_ms_per_step, "device_ms_per_step": busy,
           "device_idle_share": 1 - busy / wall_ms_per_step,
           "device_launches_per_step": sum(c for _, c in kernels.values()),
           "gemm_f32_ms": gemm["f32"], "gemm_other_ms": gemm["other"],
           "not_gemm_ms": busy - gemm["f32"] - gemm["other"]}
    log(f"train step: {json.dumps(res)}; top device time:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, launches) in top:
        log(f"  {ms:.2f} ms  x{launches:.0f}  {name[:100]}")
    res["top"] = [[name[:100], ms, c] for name, (ms, c) in top]
    del state, step_fn
    free_card()
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
    copies, which the port never calls; None where it does not run.
    ``decode_32k_window`` is mixtral-8x7b's linear sliding-window cache at
    ``decode_32k``: bf16, B = 128, 32 over 8 heads, a 32 768-row cache read
    from ``lo`` on, the last ``swa_window`` (4 096) rows; its yardstick
    runs on head-major copies of the window alone."""
    d32 = SHAPES["decode_32k"]
    window = get_config("mixtral-8x7b").swa_window
    shapes = {"serve": (8, 12, 2, 1024, 128, torch.float32, 8, 200, 0),
              "decode_32k": (d32.global_batch, 12, 2, d32.seq_len, 128,
                             torch.bfloat16, 1, 10, 0),
              "decode_32k_window": (d32.global_batch, 32, 8, d32.seq_len,
                                    128, torch.bfloat16, 1, 10,
                                    d32.seq_len - window)}
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, (b, h, hk, s, dh, dt, copies, iters, lo) in shapes.items():
        def draw(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        pos = s - 1
        q = draw(b, h, dh)
        kv = [tuple(draw(b, s, hk, dh).permute(0, 2, 1, 3) for _ in "kv")
              for _ in range(copies)]
        heads = [(k[:, :, lo:].contiguous(), v[:, :, lo:].contiguous())
                 for k, v in kv]
        turn = [0]

        def rotating(fn, pairs):
            def call():
                k, v = pairs[turn[0] % copies]
                turn[0] += 1
                return fn(k, v)
            return call

        fns = {"kernel": rotating(
                   lambda k, v: decode_attention(q, k, v, pos, lo), kv),
               "plain": rotating(
                   lambda k, v: decode_attention_plain(q, k, v, pos, lo),
                   kv),
               "library": rotating(
                   lambda k, v: F.scaled_dot_product_attention(
                       q.unsqueeze(2), k, v, enable_gqa=True), heads)}
        try:                     # the yardstick computes the same function
            lib_out = F.scaled_dot_product_attention(
                q.unsqueeze(2), *heads[0], enable_gqa=True)[:, :, 0]
            torch.testing.assert_close(lib_out.float(),
                                       decode_attention(q, *kv[0], pos,
                                                        lo),
                                       rtol=LIB_TOL[dt], atol=LIB_TOL[dt])
        except RuntimeError as e:
            log(f"decode_attention {label}: no library yardstick ({e})")
            del fns["library"]
        yield label, (b, h, hk, s, dh, dt, pos, lo), iters, fns
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
    by CUDA events, in turns, and its bound (the ``pos + 1 - lo`` rows it
    reads); before any profiler runs."""
    res = {}
    for label, (b, h, hk, s, dh, dt, pos, lo), iters, fns in \
            decode_timing_cases(dev):
        warm = 5 if iters > 20 else 2
        times = {}
        for which in ("plain", "kernel", "library", "kernel", "plain"):
            if which in fns:
                times.setdefault(which, []).append(
                    cuda_ms(fns[which], iters=iters, warmup=warm))
        bound_ms, bound_by, nbytes = attention_bound(b, h, hk, pos + 1 - lo,
                                                     dh, dt)
        res[label] = {
            "shape": [b, h, hk, s, dh], "dtype": str(dt)[6:], "pos": pos,
            "lo": lo,
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
            "decode_32k": res["decode_32k"],
            "decode_32k_window": res["decode_32k_window"],
            "serve_shape": serve}


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


def lm_only(name: str, smi: str) -> int:
    """``--lm``: phase 13 alone, after the card and the build."""
    print(json.dumps({"lm": lm_path(torch.device("cuda"))}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


def train_only(name: str, smi: str) -> int:
    """``--train``: phase 14 alone, after the card and the build."""
    print(json.dumps({"train": train_path(torch.device("cuda"))}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


def mesh_only(name: str, smi: str) -> int:
    """``--mesh``: phase 15 alone, after the card and the build."""
    print(json.dumps({"mesh": mesh_path(torch.device("cuda"))}))
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
    if sys.argv[1:] == ["--lm"]:
        return lm_only(name, smi)
    if sys.argv[1:] == ["--train"]:
        return train_only(name, smi)
    if sys.argv[1:] == ["--mesh"]:
        return mesh_only(name, smi)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    window = check_window_agg(dev)
    # phase 11 holds the fused accumulate against its plain version;
    # phases 4, 9, 10 and 12 run it
    acc = {"name": "accumulate", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/window_agg.cu",
           "replaces": "src/repro/kernels/window_agg.py:54",
           "replaces_jnp": "src/repro/streaming/window.py:116"}
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
    # phases 12 and 13 before phase 11: the profiler slows every launch
    # after it
    faults = faults_path(dev)
    lms = lm_path(dev)
    trains = train_path(dev)
    meshes = mesh_path(dev, trains)
    attn["launches_by_path"] = {
        "serve_qwen2": serve["decode_attention_launches"],
        "lm_mixtral": lms["mixtral"]["decode_attention_launches"],
        "lm_rwkv6": lms["rwkv6"]["decode_attention_launches"],
        "lm_jamba": lms["jamba"]["decode_attention_launches"],
        "lm_int8_cache": lms["int8_cache"]["decode_attention_launches"],
        "lm_linear_swa": lms["int8_cache"]["linear_swa"][
            "decode_attention_launches"]}
    attn["launches_by_path"]["train_olmo"] = trains["full_width"][
        "launches"]["decode_attention"]
    attn["launches_by_path"]["mesh_ranks"] = meshes["launches"][
        "decode_attention"]
    attn["launches"] = sum(attn["launches_by_path"].values())
    acc["launches_by_path"] = {
        "q5_run_stream": path["launches"]["accumulate"],
        "q5_ranks_route": ranks["route"]["launches"]["accumulate"],
        "engine_equivalence": engine["equivalence"]["accumulate_launches"],
        "engine_paced": engine["paced"]["accumulate_launches"],
        "faults_reference_stream":
            faults["reference_stream"]["accumulate_launches"],
        "faults_paper_shape": faults["paper_shape"]["accumulate_launches"],
        "faults_finished_source":
            faults["finished_source"]["accumulate_launches"],
        "train_olmo": trains["full_width"]["launches"]["accumulate"],
        "mesh_ranks": meshes["launches"]["accumulate"]}
    acc["launches"] = sum(acc["launches_by_path"].values())
    window["launches_by_path"] = {
        "q5_run_stream": path["launches"]["window_agg"],
        "train_olmo": trains["full_width"]["launches"]["window_agg"],
        "mesh_ranks": meshes["launches"]["window_agg"]}
    for entry in routes:
        entry["launches_by_path"] = {
            "q5_ranks_route": entry["launches"],
            "train_olmo": trains["full_width"]["launches"][entry["name"]],
            "mesh_ranks": meshes["launches"][entry["name"]]}
    # phase 11: event timings first, then the profiler
    attn.update(time_decode_attention(dev))
    time_route(dev, routes)
    op_timing, op_calls = time_window_agg(dev)
    window.update(op_timing)
    acc.update(time_accumulate(dev))
    emit = {"name": "emit"}
    emit_timing, emit_calls = time_emit(dev)
    emit.update(emit_timing)
    resources = new_kernel_resources(dev)
    acc["resources"] = resources["accumulate_ptxas"]
    emit["resources"] = resources["emit_ptxas"]
    routes[2]["resources"] = {k: resources[k] for k in (
        "route_pack_ptxas", "route_pack_cluster")}
    profile_route(dev, routes)
    profile_window_agg(op_calls, window)
    profile_emit(emit_calls, emit)
    profile_decode_attention(dev, attn)
    serve_prof = profile_serve(dev, cfg, params, step_ms)
    del params
    train_prof = profile_train(dev, trains["full_width"]["step_ms_p50"])
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s")
    print(json.dumps({"main_path": path, "latency": lat, "summing": summ,
                      "serve": serve, "serve_tf32": tf32,
                      "serve_card_vs_cpu": vs_cpu,
                      "serve_profile": serve_prof,
                      "train_profile": train_prof, "q5_ranks": ranks,
                      "engine": engine, "faults": faults, "lm": lms,
                      "train": trains, "mesh": meshes,
                      "total_s": total}))
    print(json.dumps({"kernels": [window, acc, emit, attn, *routes]}))
    print(smi)
    # the run uses one card, whatever the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
