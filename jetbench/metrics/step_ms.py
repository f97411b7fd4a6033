"""``step_ms``: host ms a step in the benchmark's ``step`` span, over the
window's steps before the profiler starts, averaged over the ranks."""


def read(run):
    recs = [r for r in run["records"] if "spans" in r]
    if not recs:
        return None
    return sum(r["spans"]["step"] for r in recs) / len(recs)
