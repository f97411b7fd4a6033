"""``device_idle``: the share of the profiled stretch in which no kernel,
copy or memset ran on the card, averaged over the ranks."""


def read(run):
    recs = [r for r in run["records"] if r.get("trace")]
    if not recs or any(r["trace"]["busy_s"] <= 0 for r in recs):
        return None
    return 100.0 * sum(1 - r["trace"]["busy_s"] / r["trace"]["window_s"]
                       for r in recs) / len(recs)
