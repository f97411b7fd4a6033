"""The control of ``correct``: the reference put in the program's place and
computed in lower precisions, held to the same comparison.

    python3 jetbench/control.py --workload q5-paper.catchup8 \\
        --steps 5000 --seeds 11 12 13

For each seed it builds the cell's pool as a run does, computes the
windows a run of ``--steps`` steps emits with :func:`reference.
control_counts` in float32 (IEEE), TF32 and bfloat16 (on the card where
there is one), and prints each precision's numbers compared, one JSON
line per seed.  A benchmark run never calls it.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".")
                        != os.path.dirname(os.path.abspath(__file__))]


def control(workload, seed, steps, precisions=("float32", "tf32",
                                               "bfloat16")):
    import numpy as np

    from jetbench.harness import lookup
    from jetbench.reference import q5 as reference
    from jetbench.source.nexmark import ReplayPool

    _, _, cfg, traffic = lookup(workload)
    pool = ReplayPool(cfg, traffic, seed)
    slide = cfg["slide_ms"]
    hist = reference.frame_histograms(
        pool.cols["ts"], pool.cols["key"], pool.cols["valid"], slide,
        pool.steps * pool.frames_per_step, 0, cfg["n_key_buckets"])
    windows = reference.Windows(hist, cfg["window_ms"] // slide)
    n_due = steps * pool.frames_per_step - 1
    out = {"seed": seed, "steps": steps, "windows": n_due}
    for p in precisions:
        res = reference.control_counts(windows, hist, np.arange(n_due),
                                       slide, p)
        out[p] = reference.compare(res, windows, slide, n_due * slide)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    for s in args.seeds:
        print(json.dumps(control(args.workload, s, args.steps)), flush=True)
