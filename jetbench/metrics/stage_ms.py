"""``stage_ms``: host ms a step in the benchmark's ``stage`` span, over the
window's steps before the profiler starts, averaged over the ranks."""


def read(run):
    recs = [r for r in run["records"] if "spans" in r]
    if not recs:
        return None
    return sum(r["spans"]["stage"] for r in recs) / len(recs)
