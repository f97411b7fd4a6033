"""One run of one cell: look everything up by name, drive the window, read
the metrics, hold the outputs to the reference, print the result.

Everything of one configuration, traffic mix, metric or driver sits in a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* the cell: ``BENCHMARK.json``'s ``workloads`` entry ``<workload>``;
* its configuration: the file its ``configs`` entry names;
* its traffic: ``jetbench/traffic/<traffic>.json``;
* the driver: ``jetbench/drivers/<driver>.py``, ``driver`` in the
  configuration file, with ``run(job)`` returning one record per rank;
* each metric: ``jetbench/metrics/<metric>.py``, with ``read(run)``
  returning a number or None (nothing to read: the metric is left out).

With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones (those whose ``workloads`` list the cell,
or every one without the key).  The last line of standard output is the
result, as JSON; the lines before it on standard error, last of all each
number compared beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .yardstick import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the limit of each number compared: every check is exact
LIMITS = {"max_count_gap": 0, "windows_missing": 0, "windows_extra": 0,
          "dropped_events": 0}
#: seconds a run may take in all, and what its ranks may take of them
RUN_LIMIT_S = 340


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def lookup(workload: str, benchmark: Optional[Dict] = None):
    """The cell's entry, its configuration and its traffic, by name."""
    bench = benchmark or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, traffic


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``workload`` reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metric(name: str, run: Dict) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        f"jetbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(run)
    return None if value is None else float(value)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: Optional[float] = None,
             overrides: Optional[Dict] = None,
             benchmark: Optional[Dict] = None) -> Dict:
    """Drive one run of ``workload`` and return its result line (a dict)
    and the notes printed before it.  ``overrides`` updates the
    configuration, the traffic and the driver's job (``{"cfg": {...},
    "traffic": {...}, "job": {...}}``): the tests' small sizes, and
    ``job["before"]``, functions (``module:function``) every rank calls
    first, the tests' faults.  ``benchmark`` stands in for
    ``BENCHMARK.json``."""
    started = time.time() if started is None else started
    bench, cell, cfg, traffic = lookup(workload, benchmark)
    overrides = overrides or {}
    cfg.update(overrides.get("cfg", {}))
    traffic.update(overrides.get("traffic", {}))
    driver = importlib.import_module(f"jetbench.drivers.{cfg['driver']}")
    job = {"cfg": cfg, "traffic": traffic, "seed": seed,
           "seconds": seconds, "trace": bool(trace), "device": device,
           "timeout_s": max(30.0, RUN_LIMIT_S - (time.time() - started))}
    job.update(overrides.get("job", {}))
    records = driver.run(job)
    run = {"records": records, "started": started, "cell": cell,
           "cfg": cfg, "traffic": traffic}
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = merge_checks(records)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    first = records[0]
    line = {"correct": correct,
            "attempted": sum(r["events"] for r in records),
            "failed": checks["dropped_events"]["value"],
            "metrics": metrics,
            "device": device_block(records, device, trace)}
    if trace:
        line["breakdown"] = {
            "device_ops": tracing.top(first["trace"]["device_s"]),
            "idle_gaps": tracing.top(first["trace"]["gaps"])}
    line["checks"] = checks
    notes = [f"{workload}: seed {seed}, {first['steps']} steps of "
             f"{sum(r['events'] for r in records) // first['steps']} "
             f"events in {max(r['window_s'] for r in records):.3f} s",
             "source ms a step (rank 0, its own work only): "
             f"{first['source_ms']:.4f}",
             "ms a step by quarter of the window (rank 0): "
             + json.dumps(first["quarters_ms"]),
             f"counters (rank 0): {json.dumps(first['counters'])}",
             "set-up (rank 0), s: " + json.dumps(setup_parts(first,
                                                               started))]
    return {"line": line, "notes": notes}


def setup_parts(rec: Dict, started: float) -> Dict:
    """Where rank 0's set-up went, in seconds."""
    m = rec["marks"]
    parts = {"imports_and_launch": m["entered"] - started,
             "pool_and_mesh": m["pool"] - m["entered"],
             "warm_up": m["warm"] - m["pool"],
             "calibration": m["calibrated"] - m["warm"],
             "to_the_window": rec["window_start"] - m["calibrated"]}
    if "profiler_start_s" in m:
        parts["profiler_start_in_window"] = m["profiler_start_s"]
    return parts


def merge_checks(records: List[Dict]) -> Dict:
    """The numbers compared, over every rank's key buckets; the drop
    counters are replicated, so rank 0's are the whole run's."""
    gap = max(r["checks"]["max_count_gap"] for r in records)
    values = {
        "max_count_gap": gap,
        "windows_missing": sum(r["checks"]["windows_missing"]
                               for r in records),
        "windows_extra": sum(r["checks"]["windows_extra"] for r in records),
        "dropped_events": records[0]["dropped"]["late"]
        + records[0]["dropped"]["conflict"]}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def device_block(records: List[Dict], device: str, trace: bool) -> Dict:
    import torch

    block = {"platform": "gpu" if device == "cuda" else device,
             "kind": torch.cuda.get_device_name(0) if device == "cuda"
             else device,
             "count": len(records),
             "memory_peak_bytes": max(r["memory_peak_bytes"]
                                      for r in records)}
    if trace:
        block["busy_s"] = sum(r["trace"]["busy_s"] for r in records) \
            / len(records)
        block["window_s"] = sum(r["trace"]["window_s"] for r in records) \
            / len(records)
    return block


def parse(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="jetbench/run.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Sequence[str], started: float) -> int:
    args = parse(argv)
    bench, cell, _, _ = lookup(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA devices; this "
              f"machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   started=started)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    for note in out["notes"]:
        print(note, file=sys.stderr)
    for name, c in out["line"]["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0
