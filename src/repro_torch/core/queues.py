"""Single-producer single-consumer bounded queues.

Jet connects each pair of communicating tasklets with a wait-free SPSC ring
buffer; a full queue is the local backpressure signal (the producer backs off
from its cooperative thread instead of blocking).  When both tasklets live in
one process (the in-process backend, or two tasklets on the same worker under
the multiprocess backend) the queues are stepped by one driver thread, so
plain index arithmetic *is* wait-free; the API surface (offer/poll never
block, ``offer`` returning ``False`` == backpressure) is preserved exactly.

This class also defines the *transport contract* every edge implementation
(:class:`SPSCQueue`, :class:`~repro_torch.core.backpressure.NetworkLink`,
the reference's ``core/shm_ring.py::ShmRing``) shares: ``offer``/
``offer_many``/``has_room_for`` on the producer side, ``poll``/``peek``/``poll_prefix``/
``poll_many`` on the consumer side.  ``has_room_for(item)`` answers whether
an immediate ``offer(item)`` is guaranteed to succeed — block routing uses
it for all-or-nothing sub-block admission, which a slot count alone cannot
promise on byte-capacity transports.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from .events import Event, EventBlock


class SPSCQueue:
    """Fixed-capacity ring buffer with non-blocking offer/poll."""

    __slots__ = ("_buf", "_cap", "_head", "_tail")

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._cap = capacity
        self._buf: List[Any] = [None] * capacity
        self._head = 0  # next slot to poll
        self._tail = 0  # next slot to fill

    # -- producer side -----------------------------------------------------
    def offer(self, item) -> bool:
        """Enqueue ``item``; returns False (backpressure) when full."""
        if self._tail - self._head == self._cap:
            return False
        # jetlint: disable=ring-role-violation -- _buf slot writes are disjoint by cursor ownership: the producer fills [tail % cap] (unreachable to the consumer until tail publishes) and the consumer None-clears [head % cap, tail % cap) it already owns
        self._buf[self._tail % self._cap] = item
        self._tail += 1
        return True

    def offer_many(self, items: List[Any], start: int = 0,
                   end: Optional[int] = None) -> int:
        """Enqueue ``items[start:end]`` until full; returns the count
        accepted.

        The accepted prefix lands in one slice-assignment per ring segment,
        so a batch costs O(segments), not O(items) of Python bookkeeping.
        """
        cap = self._cap
        head, tail = self._head, self._tail
        n = (len(items) if end is None else end) - start
        free = cap - (tail - head)
        if n > free:
            n = free
        if n <= 0:
            return 0
        buf = self._buf
        idx = tail % cap
        seg = cap - idx
        if n <= seg:
            buf[idx:idx + n] = items[start:start + n]
        else:
            buf[idx:] = items[start:start + seg]
            buf[:n - seg] = items[start + seg:start + n]
        self._tail = tail + n
        return n

    def remaining_capacity(self) -> int:
        return self._cap - (self._tail - self._head)

    def has_room_for(self, item) -> bool:
        """True when an immediate ``offer(item)`` must succeed (transport
        contract; a slot queue needs exactly one free slot per item)."""
        return self._tail - self._head < self._cap

    # -- consumer side -----------------------------------------------------
    def poll(self) -> Optional[Any]:
        """Dequeue one item or return None when empty."""
        if self._head == self._tail:
            return None
        idx = self._head % self._cap
        item = self._buf[idx]
        self._buf[idx] = None
        self._head += 1
        return item

    def peek(self) -> Optional[Any]:
        if self._head == self._tail:
            return None
        return self._buf[self._head % self._cap]

    def poll_many(self, limit: int) -> List[Any]:
        """Dequeue up to ``limit`` items as a list (may be empty)."""
        n = self._tail - self._head
        if limit < n:
            n = limit
        if n <= 0:
            return []
        buf, cap = self._buf, self._cap
        idx = self._head % cap
        seg = cap - idx
        if n <= seg:
            out = buf[idx:idx + n]
            buf[idx:idx + n] = [None] * n
        else:
            out = buf[idx:] + buf[:n - seg]
            buf[idx:] = [None] * seg
            buf[:n - seg] = [None] * (n - seg)
        self._head += n
        return out

    def poll_prefix(self, limit: int,
                    explode_blocks: bool = False) -> Tuple[List[Any], Any]:
        """Batched, control-aware drain for the tasklet hot path.

        Dequeues the leading run of data items — :class:`Event`s and
        :class:`EventBlock`s — (up to ``limit`` queue slots) as a list; if
        the next item is a control item (watermark, barrier, DONE) it is
        dequeued too and returned separately.  Stopping *before* any item
        that follows a control item keeps the drain observably identical
        to the seed item-at-a-time loop, while the common case — a long
        run of events — moves as C-level slices with one type check per
        item.

        ``explode_blocks=True`` replaces each EventBlock in the run with
        its per-event explosion (the tasklet's shim for processors that do
        not declare block support); the block still counts as one slot
        toward ``limit``.

        Returns ``(events, control_item_or_None)``.
        """
        n = self._tail - self._head
        if limit < n:
            n = limit
        if n <= 0:
            return (), None
        buf, cap = self._buf, self._cap
        idx = self._head % cap
        seg = cap - idx
        if n <= seg:
            chunk = buf[idx:idx + n]
        else:
            chunk = buf[idx:] + buf[:n - seg]
        ctrl = None
        k = n
        block_at = None
        for pos, item in enumerate(chunk):
            cls = item.__class__
            if cls is Event:
                continue
            if cls is EventBlock:
                if explode_blocks and block_at is None:
                    block_at = pos
                continue
            if isinstance(item, (Event, EventBlock)):
                continue
            ctrl = item
            k = pos
            break
        if block_at is None or block_at >= k:
            events = chunk if k == n and ctrl is None else chunk[:k]
        else:
            # explode shim: splice each block's event run into position
            events = chunk[:block_at]
            ext = events.extend
            for item in chunk[block_at:k]:
                if item.__class__ is EventBlock:
                    ext(item.to_events())
                else:
                    events.append(item)
        consumed = k + (1 if ctrl is not None else 0)
        # clear the consumed slots segment-wise
        if consumed <= seg:
            buf[idx:idx + consumed] = [None] * consumed
        else:
            buf[idx:] = [None] * seg
            buf[:consumed - seg] = [None] * (consumed - seg)
        self._head += consumed
        return events, ctrl

    def drain_to(self, sink: list, limit: int) -> int:
        """Move up to ``limit`` items into ``sink`` (a list). Returns count."""
        n = min(limit, self._tail - self._head)
        buf, cap, head = self._buf, self._cap, self._head
        for i in range(n):
            idx = (head + i) % cap
            sink.append(buf[idx])
            buf[idx] = None
        self._head = head + n
        return n

    # -- shared -------------------------------------------------------------
    def __len__(self) -> int:
        return self._tail - self._head

    @property
    def capacity(self) -> int:
        return self._cap

    def is_empty(self) -> bool:
        return self._head == self._tail

    def is_full(self) -> bool:
        return self._tail - self._head == self._cap
