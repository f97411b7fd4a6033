"""The plain reference of NEXMark Q5 (bids per auction over a sliding
window) and the comparison that decides a run's ``correct``.

NumPy only: it imports nothing of the program.  It takes the same input
columns the program is handed (``ts``, ``key``, ``valid``) and works the
answer out from them alone:

* frame ``f`` holds the events with ``ts // slide_ms == f``;
* the window ending at ``(L + 1) * slide_ms`` holds frames ``L -
  frames_per_window + 1 .. L`` (those below 0 are empty);
* its result is, for every key bucket, the number of valid events in it.

A replayed stream repeats a pool of ``Pf`` frames: frame ``f`` of the run
is pool frame ``f % Pf``.  A window's counts are then differences of the
pool's prefix sums, ``C(j) = (j // Pf) * total + prefix[j % Pf]``, exact
in int64.

:func:`control_counts` is the control: the same windows computed as the
program's emission computes them (a product of window masks with per-frame
panes) in a chosen precision, to show which precision the comparison
catches.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


def frame_histograms(ts: np.ndarray, key: np.ndarray, valid: np.ndarray,
                     slide_ms: int, n_frames: int, key_lo: int,
                     key_hi: int) -> np.ndarray:
    """``(n_frames, key_hi - key_lo)`` int64: valid events per (frame, key
    bucket) for buckets in ``[key_lo, key_hi)``; frames outside ``[0,
    n_frames)`` raise."""
    frame = ts.astype(np.int64) // slide_ms
    keep = valid & (key >= key_lo) & (key < key_hi)
    if keep.any() and (frame[keep].min() < 0
                       or frame[keep].max() >= n_frames):
        raise ValueError("an event lies outside the pool's frames")
    width = key_hi - key_lo
    flat = frame[keep] * width + (key[keep].astype(np.int64) - key_lo)
    return np.bincount(flat, minlength=n_frames * width).reshape(
        n_frames, width)


class Windows:
    """Window counts of a stream that repeats ``hist``'s frames."""

    def __init__(self, hist: np.ndarray, frames_per_window: int):
        self.frames = hist.shape[0]
        self.F = frames_per_window
        self.prefix = np.zeros((self.frames + 1, hist.shape[1]), np.int64)
        np.cumsum(hist, axis=0, out=self.prefix[1:])
        self.total = self.prefix[-1]

    def _cum(self, j: np.ndarray) -> np.ndarray:
        """Valid events per bucket in the run's frames ``[0, j)``."""
        q, r = np.divmod(j, self.frames)
        return q[:, None] * self.total[None, :] + self.prefix[r]

    def counts(self, L: np.ndarray) -> np.ndarray:
        """``(len(L), K)`` int64: the windows ending at ``(L + 1) *
        slide``."""
        L = np.asarray(L, np.int64)
        return self._cum(L + 1) - self._cum(np.maximum(L + 1 - self.F, 0))

    def multiplicity(self, L: np.ndarray) -> np.ndarray:
        """``(len(L), frames)``: how often each pool frame lies in each
        window (the emission's window mask, folded onto the pool)."""
        L = np.asarray(L, np.int64)[:, None]
        lo, hi = np.maximum(L - self.F + 1, 0), L
        p = np.arange(self.frames)[None, :]
        return (np.floor_divide(hi - p, self.frames)
                - np.floor_divide(lo - 1 - p, self.frames))


def compare(results: Iterable[Tuple[np.ndarray, np.ndarray]],
            windows: Windows, slide_ms: int, last_end: int,
            chunk_rows: int = 2048) -> Dict[str, float]:
    """Hold a run's emitted windows to the reference.

    ``results``: ``(window_ends, rows)`` pairs as ``run_stream`` returns
    them; ``last_end``: the last window end the stream's final watermark
    has reached, so windows ``slide_ms, 2 slide_ms, .., last_end`` are due.
    Returns ``max_count_gap`` (the widest ``|got - want|`` over every
    emitted (window, bucket); infinite for a value that is not finite),
    ``windows_missing`` (due, never emitted) and ``windows_extra``
    (emitted twice, or not due)."""
    n_due = last_end // slide_ms
    seen = np.zeros(max(n_due, 0), np.int64)
    gap, extra = 0.0, 0
    ends_buf, rows_buf, held = [], [], 0

    def flush():
        nonlocal gap, extra
        if not ends_buf:
            return
        ends = np.concatenate(ends_buf).astype(np.int64)
        rows = np.concatenate(rows_buf)
        ends_buf.clear()
        rows_buf.clear()
        L = ends // slide_ms - 1
        due = (ends % slide_ms == 0) & (L >= 0) & (L < n_due)
        extra += int((~due).sum())
        if not due.any():
            return
        got = rows[due]
        if not np.isfinite(got).all():
            gap = float("inf")
            return
        np.add.at(seen, L[due], 1)
        want = windows.counts(L[due])
        gap = max(gap, float(np.abs(got.astype(np.float64) - want).max()))

    for ends, rows in results:
        ends_buf.append(np.asarray(ends))
        rows_buf.append(np.asarray(rows))
        held += len(ends_buf[-1])
        if held >= chunk_rows:
            flush()
            held = 0
    flush()
    extra += int(np.maximum(seen - 1, 0).sum())
    return {"max_count_gap": gap,
            "windows_missing": int((seen == 0).sum()),
            "windows_extra": extra}


def control_counts(windows: Windows, hist: np.ndarray, L: Sequence[int],
                   slide_ms: int, precision: str,
                   device: Optional[str] = None, block: int = 1024):
    """The windows ``L`` computed as the emission does (masks times
    per-frame panes) with PyTorch in ``precision``: ``"float32"`` (IEEE),
    ``"tf32"`` (float32 operands rounded to TF32 by the matmul unit) or
    ``"bfloat16"`` (bfloat16 operands and result).  Yields ``(ends,
    rows)`` pairs as ``run_stream`` does, with ``rows`` float32."""
    import torch

    dev = torch.device(device or ("cuda" if torch.cuda.is_available()
                                  else "cpu"))
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    if precision not in ("float32", "tf32", "bfloat16"):
        raise ValueError(f"precision {precision!r}")
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "tf32" if precision == "tf32" else "ieee"
    try:
        panes = torch.from_numpy(hist.astype(np.float32)).to(dev, dtype)
        L = np.asarray(L, np.int64)
        for i in range(0, len(L), block):
            Lb = L[i:i + block]
            m = torch.from_numpy(windows.multiplicity(Lb).astype(
                np.float32)).to(dev, dtype)
            rows = (m @ panes).float().cpu().numpy()
            yield (Lb + 1) * slide_ms, rows
    finally:
        matmul.fp32_precision = prev
