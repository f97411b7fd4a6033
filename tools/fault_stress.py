#!/usr/bin/env python3
"""Stress checks of the multiprocess backend's transport and snapshots,
in either package, on the CPU.

    PYTHONPATH=src python tools/fault_stress.py words
    PYTHONPATH=src python tools/fault_stress.py ring --package repro
    PYTHONPATH=src python tools/fault_stress.py mp --package repro_torch

``words``: two processes race on one 8-byte word of shared memory, one
writing two alternating values and one reading, first through ``struct``
(``"<q"``, as the JAX package's ring packs its cursors), then through an
int64 numpy view (as the port's does); prints how many reads saw a value
that was never written (ROADMAP.md §3, F5).

``ring``: ``--pairs`` producer/consumer process pairs at once, each
through its own 4 KB ``ShmRing`` of ``--package``; prints each pair's
count of items received in order and the first item out of order (F5).

``mp``: ``--procs`` processes at once, each running ``--runs`` Q5 jobs
on ``backend="mp"`` (2 nodes x 2 cooperative threads, 96 000 events at
60 000 a second, exactly-once or ``--guarantee none``) and comparing
each run's results with the in-process run on a virtual clock; prints
every run that differs (F6) and the totals.

The checks load the host on purpose: run them on an otherwise idle
machine, and compare packages or versions within one call.
"""

from __future__ import annotations

import argparse
import importlib
import json
import multiprocessing
import struct
import subprocess
import sys
import time
from multiprocessing import shared_memory

import numpy as np

A, B = 0x00000000FFFFFFFF, 0x7FFFFFFF00000000


def _word_writer(name: str, how: str, n: int) -> None:
    shm = shared_memory.SharedMemory(name=name)
    if how == "struct":
        q, mv = struct.Struct("<q"), shm.buf
        for i in range(n):
            q.pack_into(mv, 8, A if i & 1 else B)
        del mv
    else:
        w = np.ndarray((1,), dtype=np.int64, buffer=shm.buf, offset=8)
        for i in range(n):
            w[0] = A if i & 1 else B
        del w
    shm.close()


def _word_reader(name: str, how: str, n: int, out) -> None:
    shm = shared_memory.SharedMemory(name=name)
    torn = 0
    if how == "struct":
        q, mv = struct.Struct("<q"), shm.buf
        for _ in range(n):
            torn += q.unpack_from(mv, 8)[0] not in (A, B, 0)
        del mv
    else:
        w = np.ndarray((1,), dtype=np.int64, buffer=shm.buf, offset=8)
        for _ in range(n):
            torn += w.item(0) not in (A, B, 0)
        del w
    shm.close()
    out.put(torn)


def words(args) -> dict:
    ctx = multiprocessing.get_context("fork")
    res = {}
    for how in ("struct", "numpy"):
        shm = shared_memory.SharedMemory(create=True, size=64)
        out = ctx.Queue()
        procs = [ctx.Process(target=_word_writer,
                             args=(shm.name, how, args.reads)),
                 ctx.Process(target=_word_reader,
                             args=(shm.name, how, args.reads, out))]
        for p in procs:
            p.start()
        res[how] = {"reads": args.reads, "torn": out.get()}
        for p in procs:
            p.join()
        shm.close()
        shm.unlink()
    return res


def _ring_producer(pkg: str, ring, n: int) -> None:
    ev = importlib.import_module(pkg + ".core.events")
    i = 0
    while i < n:
        item = ev.Watermark(i) if i % 3 else ev.Event(i, i % 7, float(i))
        if ring.offer(item):
            i += 1


def _ring_consumer(ring, n: int, out) -> None:
    for i in range(n):
        while True:
            got = ring.poll()
            if got is not None:
                break
        if got.ts != i:
            out.put({"in_order": i, "got": got.ts})
            return
    out.put({"in_order": n, "got": None})


def ring(args) -> dict:
    mod = importlib.import_module(args.package + ".core.shm_ring")
    ctx = multiprocessing.get_context("fork")
    rings = [mod.ShmRing(capacity_bytes=1 << 12) for _ in range(args.pairs)]
    out = ctx.Queue()
    procs = []
    for r in rings:
        procs.append(ctx.Process(target=_ring_producer,
                                 args=(args.package, r, args.items)))
        procs.append(ctx.Process(target=_ring_consumer,
                                 args=(r, args.items, out)))
    for p in procs:
        p.start()
    pairs = [out.get(timeout=600) for _ in rings]
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():            # a producer blocked on a dead consumer
            p.kill()
            p.join()
    for r in rings:
        r.unlink()
        r.close()
    bad = sum(1 for x in pairs if x["in_order"] != args.items)
    return {"package": args.package, "items": args.items, "pairs": pairs,
            "pairs_out_of_order": bad}


def _q5_results(pkg: str, backend: str, guarantee: str) -> dict:
    core = importlib.import_module(pkg + ".core")
    engine = importlib.import_module(pkg + ".core.engine")
    nx = importlib.import_module(pkg + ".nexmark")
    clock = core.VirtualClock(auto_step=0.001) if backend == "inproc" \
        else None
    cluster = core.JetCluster(n_nodes=2, cooperative_threads=2,
                              backend=backend, clock=clock)
    out = []
    p = nx.queries.q5(
        lambda: core.PacedGeneratorSource(
            nx.NexmarkGenerator(rate=60_000, n_keys=40), rate=60_000,
            max_events=96_000),
        lambda: core.CollectorSink(out), window_ms=100, slide_ms=20)
    try:
        job = cluster.submit(p.to_dag(), core.JobConfig(
            processing_guarantee=guarantee, snapshot_interval_s=0.2))
        deadline = time.monotonic() + 300
        while job.status not in (engine.JOB_COMPLETED, engine.JOB_FAILED):
            if time.monotonic() > deadline:
                break
            cluster.step()
    finally:
        cluster.shutdown()
    got = {(ev.value.window_end, ev.key): ev.value.value for ev in out}
    return {"status": job.status, "results": got,
            "failures": [f.kind for f in job.failures],
            "snapshots": job.snapshots_taken,
            "aborted": job.snapshots_aborted}


def mp_worker(args) -> None:
    guarantee = "exactly_once" if args.guarantee == "exactly_once" \
        else "none"
    clean = _q5_results(args.package, "inproc", guarantee)["results"]
    for run in range(args.runs):
        r = _q5_results(args.package, "mp", guarantee)
        got = r.pop("results")
        low = sum(1 for k, v in got.items() if v < clean.get(k, v))
        high = sum(1 for k, v in got.items() if v > clean.get(k, v))
        missing = len(set(clean) - set(got))
        print(json.dumps(dict(r, run=run, undercounted=low,
                              overcounted=high, missing=missing,
                              equal=got == clean)), flush=True)


def mp(args) -> dict:
    cmd = [sys.executable, __file__, "mp-worker", "--package", args.package,
           "--runs", str(args.runs), "--guarantee", args.guarantee]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
             for _ in range(args.procs)]
    runs = []
    for p in procs:
        stdout, _ = p.communicate()
        runs += [json.loads(line) for line in stdout.splitlines()
                 if line.startswith("{")]
    off = [r for r in runs if not r["equal"]]
    for r in off:
        print(json.dumps(r))
    return {"package": args.package, "guarantee": args.guarantee,
            "runs": len(runs), "differ": len(off),
            "failed": sum(1 for r in runs if r["status"] != "completed")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("check", choices=("words", "ring", "mp", "mp-worker"))
    ap.add_argument("--package", default="repro_torch",
                    choices=("repro", "repro_torch"))
    ap.add_argument("--reads", type=int, default=3_000_000)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--items", type=int, default=300_000)
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--runs", type=int, default=24)
    ap.add_argument("--guarantee", default="exactly_once",
                    choices=("exactly_once", "none"))
    args = ap.parse_args()
    if args.check == "mp-worker":
        mp_worker(args)
        return 0
    res = {"words": words, "ring": ring, "mp": mp}[args.check](args)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
