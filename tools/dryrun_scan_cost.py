"""What the dry run's counting scan saves on one cell: the cell run with
``chunked_time_scan``'s counting path over meta tensors, then with the
step-by-step loop, each in a process of its own, cut in depth and
sequence so that the loop ends in minutes.  Prints both ``step_s`` (CPU
seconds), whether the two records are equal but for their seconds, and
the seconds the loop adds a layer a 1 000 time steps of the cut cell,
from which an uncut cell's loop time is reckoned.

    PYTHONPATH=src python tools/dryrun_scan_cost.py rwkv6-7b train_4k \\
        --layers 1 --seq 512 [--multi-pod]
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def run(arch: str, shape: str, layers: int, seq: int, multi_pod: bool,
        loop: bool) -> dict:
    """The cut cell's record, with ``loop`` stepping its scans."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import layers as layers_mod
    if loop:                    # the scan's own branch where it cannot count
        layers_mod._profile_step = lambda *args: None
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    specs.get_config = lambda name: cfg
    specs.SHAPES = dict(SHAPES, **{shape: dataclasses.replace(
        SHAPES[shape], seq_len=seq)})
    return dryrun.run_cell(arch, shape, multi_pod=multi_pod)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--child", choices=["count", "loop"])
    args = ap.parse_args(argv)
    if args.child:
        r = run(args.arch, args.shape, args.layers, args.seq, args.multi_pod,
                args.child == "loop")
        print("RESULT " + json.dumps(r))
        return 0
    env = dict(os.environ, PYTHONPATH=str(SRC))
    records = {}
    for child in ("count", "loop"):
        out = subprocess.run(
            [sys.executable, __file__, *(argv if argv is not None
                                         else sys.argv[1:]),
             "--child", child],
            env=env, capture_output=True, text=True, check=True).stdout
        line = [l for l in out.splitlines() if l.startswith("RESULT ")][0]
        records[child] = json.loads(line[len("RESULT "):])
    step = {k: r.pop("step_s") for k, r in records.items()}
    for r in records.values():
        r.pop("build_s")
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "layers": args.layers,
        "seq": args.seq, "mesh": records["count"]["mesh"],
        "count_step_s": step["count"], "loop_step_s": step["loop"],
        "records_equal": records["count"] == records["loop"],
        "loop_extra_s_a_layer_a_1000_steps": (step["loop"] - step["count"])
        / args.layers / args.seq * 1000}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
