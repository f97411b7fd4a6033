"""Spans and counts of the device tier's work, kept in memory.

To see where a stream's host time goes, pass a :class:`Tracer` to
``StreamExecutor(..., tracer=...)`` and read :meth:`Tracer.summary` (or
the difference of two :meth:`Tracer.mark`) when it suits you; nothing is
written anywhere.  Without one the executor uses :data:`NULL`, whose spans
are one shared no-op.

Each span records its name, the index of the stream step it belongs to,
the span it was opened inside, and its start and end on
``time.perf_counter_ns()``.  ``run_stream`` sets the index: staging a
batch carries the index of the step that will run it (batch ``i + 1`` is
staged while step ``i`` is under way), a step's collect and harvest carry
that step's, and the indices of a second stream run on from the first's,
so the spans of two streams never share one.  Per name the tracer sums
the calls, the time and the self time (the time less what the spans
opened inside it cover), over every span; the spans themselves are kept
in a ring of fixed size, the last :data:`RING` of them.

While a ``torch.profiler`` is recording, each span also opens a profiler
annotation of its name, so the span lands in the exported trace on the
profiler's own clock, beside the card's kernels and copies: the launches
made inside a span can be told apart from the others.  With no profiler
running no annotation is opened (one costs about 14 us on a CPU).

The executor's spans:

======================  ==================================================
``stream.stage``        ``stage_batch``, the whole call: the host count of
                        ``valid``, the fill of the batch's pinned slot and
                        its one copy to the card queued
``stream.stage.pin``    the fill of the batch's pinned slot (one a batch on
                        a card)
``stream.step``         ``step``, the whole call
``stream.accumulate``   the dispatch of ``accumulate`` (one kernel launch)
``stream.exchange``     on a mesh, the collectives of a step: the route
                        plan's ``route_pack`` and all-to-all, then the
                        watermark's and counters' reductions; the reduce
                        plan's ``psum_scatter`` and reductions
``stream.emit``         emission, the whole call (on a card the emit
                        kernel's launch and its status read; on the CPU
                        the plain version's rounds)
``stream.emit.read``    one blocking read of the card by emission; there
                        are as many as the executor's ``host_syncs`` (one
                        a step on a card)
``stream.collect``      ``run_stream``'s keeping of a step's valid result
                        rows, one a step that emitted: on a card the
                        step's two ``non_blocking`` copies queued into the
                        open chunk of the pinned result ring; on the CPU
                        the rows cut and cloned
``stream.harvest``      on a card, the loop's hand-off of a full chunk to
                        the helper thread (waiting while the helper holds
                        the chunk it opens next) and, at the end, the last
                        chunk's hand-off and the helper's join; on the CPU
                        the copy of the collected rows to host arrays
                        (every ``COLLECT_CHUNK`` steps and at the end)
======================  ==================================================

The helper thread that turns a card's result chunks into the caller's
arrays (``streaming.results``) records no span: a tracer serves one
thread.  The executor counts its work instead: ``result_chunks`` (chunks
delivered) and ``result_ring_waits`` (hand-offs that waited for the
helper), beside staging's ``stage_slot_fills``, ``stage_slot_waits`` and
``stage_slot_layouts`` and emission's ``host_syncs`` and ``emit_rounds``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import torch

#: spans a tracer keeps (a Q5 step opens about a dozen)
RING = 8192


class Span(NamedTuple):
    """One closed span: ``parent`` is the ``id`` of the span it was opened
    inside (None at the top); times in ``perf_counter`` nanoseconds."""
    id: int
    name: str
    step: int
    parent: Optional[int]
    start_ns: int
    end_ns: int


class _Open:
    """A span while it is open (the context manager ``Tracer.span``
    returns)."""

    __slots__ = ("tracer", "name", "id", "step", "parent", "start", "child",
                 "note")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack
        self.parent = stack[-1].id if stack else None
        self.id = tr._next_id
        tr._next_id += 1
        self.step = tr.step
        self.child = 0
        self.note = None
        if torch._C._autograd._profiler_enabled():
            self.note = torch.profiler.record_function(self.name)
            self.note.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        tr = self.tracer
        tr._stack.pop()
        if self.note is not None:
            self.note.__exit__(None, None, None)
        took = end - self.start
        sums = tr._sums.get(self.name)
        if sums is None:
            sums = tr._sums[self.name] = [0, 0, 0]
        sums[0] += 1
        sums[1] += took
        sums[2] += took - self.child
        if tr._stack:
            tr._stack[-1].child += took
        tr._ring.append((self.id, self.name, self.step, self.parent,
                         self.start, end))
        return False


class Tracer:
    """Spans and per-name sums of one executor's work (one thread: spans
    nest as the ``with`` blocks that open them)."""

    def __init__(self):
        #: the stream step the spans opened now belong to
        self.step = 0
        self._next_id = 0
        self._stack: list = []
        self._sums: Dict[str, list] = {}
        self._ring: collections.deque = collections.deque(maxlen=RING)

    def span(self, name: str) -> _Open:
        """A context manager recording one span named ``name``."""
        return _Open(self, name)

    def at_step(self, step: int) -> None:
        """Give the spans opened from now on the index ``step``."""
        self.step = step

    def mark(self) -> Dict[str, Tuple[int, int, int]]:
        """Per name, ``(calls, total_ns, self_ns)`` so far: a copy, so the
        difference of two marks is what ran between them."""
        return {k: tuple(v) for k, v in self._sums.items()}

    def summary(self) -> Dict:
        """``totals``, per name ``{calls, total_ns, self_ns}``, and
        ``spans``, the ring's spans oldest first."""
        return {"totals": {k: dict(zip(("calls", "total_ns", "self_ns"), v))
                           for k, v in self._sums.items()},
                "spans": [Span._make(s) for s in self._ring]}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


class NullTracer:
    """The tracer that records nothing."""

    _NO_SPAN = _NoSpan()
    step = 0

    def span(self, name: str) -> _NoSpan:
        return self._NO_SPAN

    def at_step(self, step: int) -> None:
        pass

    def mark(self) -> Dict[str, Tuple[int, int, int]]:
        return {}

    def summary(self) -> Dict:
        return {"totals": {}, "spans": []}


#: the default tracer of every executor
NULL = NullTracer()


class _Active(threading.local):
    tracer = NULL


_ACTIVE = _Active()


def active():
    """The tracer of the step running on this thread (``NULL`` outside
    one): how ``window.accumulate`` and ``window.emit`` find it."""
    return _ACTIVE.tracer


class activate:
    """Make ``tracer`` the one :func:`active` returns on this thread for a
    ``with`` block (the executor does, around each step)."""

    __slots__ = ("tracer", "prev")

    def __init__(self, tracer):
        self.tracer = tracer

    def __enter__(self):
        self.prev = _ACTIVE.tracer
        _ACTIVE.tracer = self.tracer
        return self.tracer

    def __exit__(self, *exc) -> bool:
        _ACTIVE.tracer = self.prev
        return False
