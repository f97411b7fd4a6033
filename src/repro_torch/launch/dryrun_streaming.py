"""Dry run of the paper's own workload on the production mesh: the
device-tier Q5 step (keyed exchange, pane accumulation, window emission)
and its ring-replication snapshot, for the 16x16 mesh (or 2x16x16).

The port of ``repro/launch/dryrun_streaming.py``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun_streaming \\
        [--multi-pod] [--exchange reduce|route|both]

In a fake world of 256 (or 512) ranks (``launch.dryrun.fake_world``), it
builds the port's ``StreamExecutor`` on the production mesh's ``"data"``
dimension at the reference's paper-extreme shape: 1 M key buckets, 1 M
events a global batch, a 10 s window sliding by 10 ms.  It runs one real
step and one snapshot on the CPU as rank 0 (its shard of the state and
its slice of a batch from ``NexmarkGenerator``).  The fake group's
collectives move no data, so the run checks shapes and counts, not
values: the state's bytes a rank, and the calls, the bytes handed to
collectives and the bytes staged through host memory, read from the
executor's own counters (``collectives.Transport``), for the step and for
the snapshot.  The reduce plan's step holds two (ring, 1 M) float32 pane
buffers (about 4 GB each) in host memory.  Results go to
``experiments/dryrun_torch/jet-q5-stream-<plan>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..nexmark import NexmarkGenerator
from ..streaming import StreamExecutor, StreamJobConfig, VectorWindowSpec
from .dryrun import OUT_DIR, fake_world
from .mesh import make_production_mesh


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def _counters(tr) -> dict:
    return {"calls": tr.calls, "collective_bytes": tr.collective_bytes,
            "host_staged_bytes": tr.host_staged_bytes}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def batch(b_loc: int, batch_size: int, keys: int) -> dict:
    """Rank 0's slice of the first global batch: NEXMark events over the
    paper's 10 000 auctions at one global batch a 10 ms slide, the auction
    id as the key bucket, bids valid."""
    gen = NexmarkGenerator(rate=batch_size * 100, n_keys=10_000)
    blk = gen.gen_block(np.arange(b_loc))
    return {"ts": blk.ts.astype(np.int32),
            "key": (blk.key % keys).astype(np.int32),
            "value": np.ones(b_loc, np.float32),
            "valid": blk.cols["kind"] == 2}


def run(exchange: str, multi_pod: bool = False, keys: int = 1 << 20,
        batch_size: int = 1 << 20) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_ranks = 512 if multi_pod else 256
    # paper-extreme Q5: 10 s window, 10 ms slide, 1M key buckets, 1M-event
    # global batches (the reference's dryrun_streaming.py:38-44)
    spec = VectorWindowSpec(size_ms=10_000, slide_ms=10, n_key_buckets=keys,
                            max_windows_per_step=2, ring_margin=24)
    with fake_world(n_ranks):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        ex = StreamExecutor(StreamJobConfig(window=spec,
                                            batch_size=batch_size,
                                            exchange=exchange),
                            mesh=mesh["data"], device="cpu")
        state = ex.init_state()
        staged, _ = ex.stage_batch(batch(ex.b_loc, batch_size, keys))
        tr = ex.transport
        t0 = time.time()
        c0 = _counters(tr)
        state, out = ex.step(state, staged)
        c1 = _counters(tr)
        backup = ex.snapshot(state)
        c2 = _counters(tr)
        wall = time.time() - t0
    result = {
        "arch": f"jet-q5-stream-{exchange}",
        "shape": f"b{batch_size}-k{keys}", "mesh": mesh_name,
        "chips": n_ranks, "kind": "stream_step", "tag": "paper-technique",
        "meta": {"window_ms": spec.size_ms, "slide_ms": spec.slide_ms,
                 "key_buckets": keys, "batch": batch_size,
                 "ring_len": spec.ring_len, "data_shards": ex.n_shards,
                 "keys_per_rank": ex.k_loc, "events_per_rank": ex.b_loc},
        "state_bytes_per_rank": _nbytes(state),
        "panes_shape": list(state["panes"].shape),
        "step": _delta(c1, c0), "snapshot": _delta(c2, c1),
        "snapshot_bytes_per_rank": _nbytes(backup),
        "results_shape": list(out["results"].shape),
        "wall_s": round(wall, 2),
    }
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out_path = OUT_DIR / f"jet-q5-stream-{exchange}__{mesh_name}.json"
    out_path.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--exchange", default="both",
                    choices=["reduce", "route", "both"])
    args = ap.parse_args(argv)
    plans = ["reduce", "route"] if args.exchange == "both" \
        else [args.exchange]
    for plan in plans:
        r = run(plan, args.multi_pod, args.keys, args.batch)
        print(f"[stream dryrun {r['mesh']} {plan}] "
              f"state/rank={r['state_bytes_per_rank'] / 2**20:.1f} MiB "
              f"step: {r['step']['calls']} calls, "
              f"{r['step']['collective_bytes'] / 1e6:.2f} MB to "
              f"collectives, {r['step']['host_staged_bytes'] / 1e6:.2f} MB "
              f"staged; snapshot: {r['snapshot']['collective_bytes'] / 1e6:.2f}"
              f" MB ({r['snapshot_bytes_per_rank'] / 2**20:.1f} MiB a rank)",
              flush=True)


if __name__ == "__main__":
    main()
