#!/usr/bin/env python3
"""Wall time a step of two checkouts of the port on one CUDA card, in turns.

    python3 tools/compare_trees.py OLD_ROOT NEW_ROOT

Each root is a checkout of this repository (its own ``chip_smoke.py`` and
``src/``), for example a ``git archive`` of an earlier commit unpacked
into a git-ignored directory.  The roots run in turns (old, new, new,
old), each turn in a fresh process that imports only that root's package
and builds its kernels into that root's ``build/kernels``.  A turn times,
at the paper's Q5 configuration (``chip_smoke.SPEC``, 65 536 events a
step):

* the one-card step: ``StreamExecutor.run_stream``, ``Q5_STEPS`` steps
  after ``WARM_STEPS``, by the host's clock around a synchronised run;
* the route step: Q5 across 4 ranks under the route exchange, one spawned
  process a rank (gloo, the ranks sharing the card, as ``chip_smoke.py``
  phase 9 runs them on a one-card host), ``ROUTE_STEPS`` steps after
  ``WARM_STEPS``, each rank's wall a step.

Every run must drop nothing, and the two roots must agree exactly on each
run's final panes (the Q5 counts are integers), so the runs compared did
the same work.  Prints one JSON line a turn, then a summary line with the
best of each root's turns.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

#: the checkout a turn runs; set for the turn's process and its ranks
TREE = os.environ.get("COMPARE_TREE")
if TREE:
    sys.path.insert(0, TREE)
    import chip_smoke as cs  # noqa: E402  (adds TREE/src to the path)
    import torch  # noqa: E402
    import torch.distributed as dist  # noqa: E402

Q5_STEPS = 300
ROUTE_STEPS = 200
WARM_STEPS = 32


def _wall(run) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _digest(state) -> dict:
    drops = (int(state["dropped_late"]), int(state["dropped_conflict"]))
    if drops != (0, 0):
        raise AssertionError(f"dropped (late, conflict) = {drops}")
    return {"panes_sum": float(state["panes"].double().sum()),
            "slot_frame_sum": int(state["slot_frame"].long().sum())}


def route_rank(rank: int, world: int, dev, steps: int, warm: int) -> dict:
    """One rank's route step: a warm run, then a timed one."""
    mesh = cs.make_data_mesh("cuda")
    batches, _ = cs.rank_batches(rank, world, max(steps, warm))

    def feed(start, size):
        return batches[start // cs.B]

    cfg = cs.StreamJobConfig(window=cs.SPEC, batch_size=cs.B,
                             exchange="route")
    cs.StreamExecutor(cfg, mesh=mesh, device=dev).run_stream(feed, warm)
    torch.cuda.synchronize()
    dist.barrier()
    ms, (state, _) = _wall(lambda: cs.StreamExecutor(
        cfg, mesh=mesh, device=dev).run_stream(feed, steps))
    return {"wall_ms_per_step": ms / steps, **_digest(state)}


def one_turn() -> dict:
    """Build this turn's tree and time its two steps."""
    t0 = time.perf_counter()
    cs.build()
    build_s = time.perf_counter() - t0
    batches, _ = cs.pinned_batches(
        cs.NexmarkGenerator(rate=cs.RATE, n_keys=cs.N_AUCTIONS),
        max(Q5_STEPS, WARM_STEPS))
    cfg = cs.StreamJobConfig(window=cs.SPEC, batch_size=cs.B)

    def feed(start, size):
        return batches[start // size]

    cs.StreamExecutor(cfg).run_stream(feed, WARM_STEPS)
    ms, (state, _) = _wall(lambda: cs.StreamExecutor(cfg).run_stream(
        feed, Q5_STEPS))
    q5 = {"wall_ms_per_step": ms / Q5_STEPS, **_digest(state)}
    ranks = cs.spawn_ranks(route_rank, cs.RANKS, backend="gloo",
                           device="cuda", args=(ROUTE_STEPS, WARM_STEPS),
                           timeout_s=600)
    return {"tree": TREE, "build_s": build_s, "q5": q5,
            "route": {"wall_ms_per_step": [r["wall_ms_per_step"]
                                           for r in ranks],
                      "digests": [{k: v for k, v in r.items()
                                   if k != "wall_ms_per_step"}
                                  for r in ranks]}}


def main(argv: list) -> int:
    if TREE:
        print(json.dumps(one_turn()), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (os.path.abspath(a) for a in argv)
    turns = []
    for tree in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            env={**os.environ, "COMPARE_TREE": tree}, cwd=tree,
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"compare_trees: the turn of {tree} failed "
                  f"({out.returncode})", file=sys.stderr)
            return 1
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    for path in (("q5",), ("route", "digests")):
        seen = set()
        for t in turns:
            x = t
            for p in path:
                x = x[p]
            if "wall_ms_per_step" in x:
                x = {k: v for k, v in x.items() if k != "wall_ms_per_step"}
            seen.add(json.dumps(x, sort_keys=True))
        if len(seen) != 1:
            raise AssertionError(f"the trees disagree on {path}: {seen}")
    summary = {}
    for label, tree in (("old", old), ("new", new)):
        mine = [t for t in turns if t["tree"] == tree]
        summary[label] = {
            "tree": tree,
            "q5_wall_ms_per_step": min(t["q5"]["wall_ms_per_step"]
                                       for t in mine),
            "route_wall_ms_per_step": [
                min(t["route"]["wall_ms_per_step"][r] for t in mine)
                for r in range(len(mine[0]["route"]["wall_ms_per_step"]))]}
    print(json.dumps({"compare_trees": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
