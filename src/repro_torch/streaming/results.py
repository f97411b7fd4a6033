"""Results of ``StreamExecutor.run_stream`` to the host without the loop
waiting on a copy.

On a card each step that emits ``n`` rows queues one ``non_blocking`` copy
of its valid rows, and one of their window ends, into the open chunk of a
:class:`ResultRing`: host chunks the executor allocates once, pinned.  A
chunk closes when the next step's rows would not fit it, and at the
stream's end: a marker is recorded behind its last copy and the chunk goes
to the stream's one helper thread (:class:`Delivery`).  The helper waits
on the marker, copies the chunk's used rows into one fresh numpy array,
appends each step's ``(ends, rows)``, views of that array, to the caller's
list in step order, and frees the chunk.  The loop waits only where the
helper still holds the chunk it opens next.  No result shares memory with
the ring, and the fresh pages are first touched on the helper's thread.

A ring is its chunks and two callables, so a test can drive the plan and
the delivery with numpy arrays and a marker that waits for nothing.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .. import tracing

#: chunks in an executor's ring: the loop fills one while the helper
#: delivers the other
RING_CHUNKS = 2


class ResultRing:
    """Host chunks ``(rows, ends)``, ``rows`` ``(budget, K)`` and ``ends``
    ``(budget,)``, as ``copy(dst, src)`` writes into them (tensors or numpy
    arrays); ``mark()`` returns a marker whose ``synchronize()`` waits for
    every copy queued before it."""

    def __init__(self, chunks: Sequence[Tuple], copy: Callable,
                 mark: Callable):
        if len(chunks) < 2:
            raise ValueError(f"a ring of {len(chunks)} chunks: the loop "
                             f"fills one while the helper delivers another")
        self.chunks = list(chunks)
        #: each chunk's ``(rows, ends)`` as numpy arrays, for the helper
        self.host = [tuple(b.numpy() if isinstance(b, torch.Tensor) else b
                           for b in c) for c in self.chunks]
        self.budget = len(self.host[0][1])
        self.copy, self.mark = copy, mark


class _Marker:
    """A CUDA event recorded on ``device``'s current stream that puts its
    waiter to sleep; waited on with ``device`` made current, so the
    helper's thread opens no context on another card."""

    def __init__(self, device: torch.device):
        self.device = device
        self.event = torch.cuda.Event(blocking=True)
        self.event.record(torch.cuda.current_stream(device))

    def synchronize(self) -> None:
        with torch.cuda.device(self.device):
            self.event.synchronize()


def pinned_ring(budget: int, k: int, device: torch.device) -> ResultRing:
    """A ring of :data:`RING_CHUNKS` pinned chunks of ``(budget, k)``
    float32 rows and ``budget`` int32 window ends, from torch's pinned
    allocator (so the blocks a freed ring held are reused), filled by
    ``non_blocking`` copies on ``device``'s current stream."""
    chunks = [(torch.empty((budget, k), dtype=torch.float32,
                           pin_memory=True),
               torch.empty(budget, dtype=torch.int32, pin_memory=True))
              for _ in range(RING_CHUNKS)]

    def copy(dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.copy_(src, non_blocking=True)

    return ResultRing(chunks, copy, lambda: _Marker(device))


class Delivery:
    """One stream's results through ``ring`` into ``results``.  A context
    manager: entering starts the helper thread; leaving hands it the last
    chunk and joins it, then raises what the helper raised (if the loop
    raised, the helper is joined and the loop's exception goes on).
    ``delivered`` counts the chunks delivered, ``waits`` the chunks the
    loop waited for the helper to free."""

    def __init__(self, ring: ResultRing, results: List,
                 tracer=tracing.NULL):
        self.ring, self.results, self.tracer = ring, results, tracer
        self.delivered = 0
        self.waits = 0
        # set while the helper does not hold the chunk; the loop holds the
        # open one
        self._free = [threading.Event() for _ in ring.chunks]
        for free in self._free[1:]:
            free.set()
        self._open, self._used, self._counts = 0, 0, []
        self._todo: queue.SimpleQueue = queue.SimpleQueue()
        self._error = None
        self._helper = threading.Thread(target=self._deliver,
                                        name="stream-results", daemon=True)

    def __enter__(self) -> "Delivery":
        self._helper.start()
        return self

    def __exit__(self, kind, *exc) -> bool:
        if kind is not None:
            self._stop()
            return False
        with self.tracer.span("stream.harvest"):
            try:
                self._hand_off()
            finally:
                self._stop()
        self._raise()
        return False

    def add(self, rows, ends, n: int) -> None:
        """Queue the copy of a step's first ``n`` rows of ``rows`` and
        ``ends`` into the open chunk, closing it first if they would not
        fit."""
        if self._used + n > self.ring.budget:
            with self.tracer.span("stream.harvest"):
                self._hand_off()
                self._open_next()
        with self.tracer.span("stream.collect"):
            lo = self._used
            dst_rows, dst_ends = self.ring.chunks[self._open]
            self.ring.copy(dst_rows[lo:lo + n], rows[:n])
            self.ring.copy(dst_ends[lo:lo + n], ends[:n])
            self._used = lo + n
            self._counts.append(n)

    def _hand_off(self) -> None:
        """The open chunk, with a marker behind its copies, to the
        helper."""
        if self._counts:
            self._todo.put((self._open, self._counts, self.ring.mark()))

    def _open_next(self) -> None:
        """Open the ring's next chunk, once the helper has freed it."""
        self._open = (self._open + 1) % len(self._free)
        self._used, self._counts = 0, []
        free = self._free[self._open]
        if not free.is_set():
            self.waits += 1
            free.wait()
        self._raise()
        free.clear()

    def _stop(self) -> None:
        self._todo.put(None)
        self._helper.join()

    def _raise(self) -> None:
        if self._error is not None:
            raise self._error

    def _deliver(self) -> None:
        """The helper: each handed-off chunk, in order, into ``results``."""
        try:
            for i, counts, marker in iter(self._todo.get, None):
                marker.synchronize()
                rows, ends = self.ring.host[i]
                used = sum(counts)
                got_rows = np.empty_like(rows[:used])
                np.copyto(got_rows, rows[:used])
                got_ends = ends[:used].copy()
                self._free[i].set()
                lo = 0
                for n in counts:
                    self.results.append((got_ends[lo:lo + n],
                                         got_rows[lo:lo + n]))
                    lo += n
                self.delivered += 1
        except Exception as e:      # raised again on the loop's thread
            self._error = e
            for free in self._free:
                free.set()
