"""``accumulate_roofline``: the share of the memory roofline that rank 0's
``accumulate`` calls reach in its profiled steps: the bytes their inputs need
(``jetbench/yardstick/roofline.py``) over their device time."""

from jetbench.yardstick.roofline import roofline_pct
from jetbench.yardstick.trace import seconds_of


def read(run):
    rec = run["records"][0]
    tr = rec.get("trace")
    if tr is None:
        return None
    s, n = seconds_of(tr, "accumulate_kernel")
    if not n or s <= 0:
        return None
    # bytes of the steps profiled, pro rata where the trace caught fewer
    nbytes = rec["kernel_bytes"]["accumulate"] * n / tr["steps"]
    return roofline_pct(nbytes, s)
