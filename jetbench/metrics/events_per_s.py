"""``events_per_s``: the events offered in the window over its seconds;
across ranks, the global events over the slowest rank's window."""


def read(run):
    recs = run["records"]
    return sum(r["events"] for r in recs) / max(r["window_s"] for r in recs)
