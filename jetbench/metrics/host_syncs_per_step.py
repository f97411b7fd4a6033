"""``host_syncs_per_step``: the executor's own ``host_syncs`` counter
(reads the emission loop makes of the device) over the window's steps,
averaged over the ranks."""


def read(run):
    recs = run["records"]
    return sum(r["counters"]["host_syncs"] / r["steps"] for r in recs) \
        / len(recs)
