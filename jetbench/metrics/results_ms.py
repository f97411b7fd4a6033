"""``results_ms``: host ms a step that ``run_stream`` spends outside the
calls it makes into the program and the source (the valid rows cut out
and copied to the host, ``_harvest``, and the loop itself): the window's
time before the profiler starts, less its ``stage``, ``step`` and
``source`` spans, over its steps, averaged over the ranks."""


def read(run):
    recs = [r for r in run["records"] if "spans" in r]
    if not recs:
        return None
    return sum(r["spans"]["results"] for r in recs) / len(recs)
