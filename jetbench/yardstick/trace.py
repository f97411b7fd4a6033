"""What a profiled stretch of the window did on the device, from the
``torch.profiler`` trace (CUPTI) exported as Chrome trace JSON.

:func:`summarize` reduces a trace to what the per-layer readers need:

* ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device; ``window_s``: from the first event of the
  trace to the end of the last;
* ``device_s``: device seconds and calls by operation name;
* ``gaps``: idle seconds of the device by what the host was doing, as
  ``<span>/<runtime call>``: the innermost of the benchmark's spans
  (``jetbench.*`` annotations; ``run_stream`` outside them: its own loop
  and copies of results) and the CUDA runtime call the host thread was
  in at the middle of the gap (``python`` where it was in none).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "jetbench."


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


class _Cover:
    """The events of one host thread that may nest, found by a point."""

    def __init__(self, events: List[Tuple[float, float, str]]):
        self.ev = sorted(events)
        self.starts = [e[0] for e in self.ev]
        self.longest = max((e[1] - e[0] for e in self.ev), default=0.0)

    def innermost(self, t: float):
        """The shortest event that holds ``t``, or None."""
        best = None
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ev[i][0] >= t - self.longest:
            lo, hi, name = self.ev[i]
            if hi > t and (best is None or hi - lo < best[1] - best[0]):
                best = self.ev[i]
            i -= 1
        return None if best is None else best[2]


def summarize(path: str) -> Dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not xs:
        return {"busy_s": 0.0, "window_s": 0.0, "device_s": {},
                "device_calls": {}, "gaps": {}}
    dev, device_s = [], defaultdict(lambda: [0.0, 0])
    spans, runtime = [], []
    host_tid = None
    for e in xs:
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((lo, hi))
            acc = device_s[e["name"]]
            acc[0] += (hi - lo) * 1e-6
            acc[1] += 1
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.append((lo, hi, e["name"][len(SPAN_PREFIX):]))
            host_tid = (e.get("pid"), e.get("tid"))
    for e in xs:
        if e.get("cat") == "cuda_runtime" and (
                host_tid is None or (e.get("pid"), e.get("tid")) == host_tid):
            lo = float(e["ts"])
            runtime.append((lo, lo + float(e["dur"]), e["name"]))
    start = min(float(e["ts"]) for e in xs)
    end = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    busy = _union(dev)
    gaps: Dict[str, float] = defaultdict(float)
    span_cover, rt_cover = _Cover(spans), _Cover(runtime)
    edges = [start] + [x for iv in busy for x in iv] + [end]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        label = (f"{span_cover.innermost(mid) or 'run_stream'}/"
                 f"{rt_cover.innermost(mid) or 'python'}")
        gaps[label] += (hi - lo) * 1e-6
    return {"busy_s": sum(hi - lo for lo, hi in busy) * 1e-6,
            "window_s": (end - start) * 1e-6,
            "device_s": {k: v[0] for k, v in device_s.items()},
            "device_calls": {k: v[1] for k, v in device_s.items()},
            "gaps": dict(gaps)}


def top(table: Dict[str, float], n: int = 10) -> List[List]:
    """The ``n`` largest entries of ``table`` as ``[name, seconds]``."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]


def seconds_of(summary: Dict, needle: str) -> Tuple[float, int]:
    """Device seconds and calls of the operations whose name holds
    ``needle``."""
    s = sum(v for k, v in summary["device_s"].items() if needle in k)
    n = sum(v for k, v in summary["device_calls"].items() if needle in k)
    return s, n
