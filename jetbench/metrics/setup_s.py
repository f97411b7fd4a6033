"""``setup_s``: from the run's start to its window's (the last rank's):
imports, the source's pool, building or loading the kernels, warm-up and
calibration."""


def read(run):
    return max(r["window_start"] for r in run["records"]) - run["started"]
