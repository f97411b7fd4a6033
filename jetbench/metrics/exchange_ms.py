"""``exchange_ms``: device ms a step of the NCCL kernels (the exchange's
all-to-all and the replicated reductions) in rank 0's profiled steps;
nothing on one card."""

from jetbench.yardstick.trace import seconds_of


def read(run):
    tr = run["records"][0].get("trace")
    if tr is None:
        return None
    s, n = seconds_of(tr, "nccl")
    return 1e3 * s / tr["steps"] if n else None
