"""Distributed-edge flow control: the adaptive receive window.

Local backpressure is just a full SPSC queue.  Across node boundaries Jet
uses a credit scheme modelled on the TCP receive window (paper §3.3): the
producer may send up to ``acked_seq + receive_window`` items; the consumer
acks every ``ACK_INTERVAL`` (100 ms) and sizes the window to roughly
``WINDOW_FILL_FACTOR`` (3×) the number of items it processed during the
last interval — i.e. ~300 ms worth of flow in steady state.

:class:`NetworkLink` simulates one ordered link between a producer instance
and a consumer instance on different nodes, with configurable one-way
latency.  The engine pumps links every scheduler iteration.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Optional, Tuple

from .clock import Clock
from .events import Event, EventBlock

ACK_INTERVAL_S = 0.1
WINDOW_FILL_FACTOR = 3
MIN_RECEIVE_WINDOW = 16
MAX_RECEIVE_WINDOW = 1 << 16


class NetworkLink:
    """Ordered, latency-ful, credit-flow-controlled SPSC link."""

    __slots__ = ("clock", "latency", "_in_flight", "_recv", "recv_capacity",
                 "sent_seq", "acked_seq", "receive_window", "_processed",
                 "_last_ack", "bytes_sent", "items_sent")

    def __init__(self, clock: Clock, latency_s: float = 0.0005,
                 recv_capacity: int = 4096,
                 initial_window: int = 1024):
        self.clock = clock
        self.latency = latency_s
        self._in_flight: Deque[Tuple[float, Any]] = deque()
        self._recv: Deque[Any] = deque()
        self.recv_capacity = recv_capacity
        self.sent_seq = 0          # items pushed by producer
        self.acked_seq = 0         # items the consumer has acknowledged
        self.receive_window = initial_window
        self._processed = 0        # consumed since last ack
        self._last_ack = clock.now()
        self.bytes_sent = 0
        self.items_sent = 0

    # -- producer side ---------------------------------------------------------
    def offer(self, item) -> bool:
        """Send if credit allows. False == remote backpressure."""
        if self.sent_seq >= self.acked_seq + self.receive_window:
            return False
        self._in_flight.append((self.clock.now() + self.latency, item))
        self.sent_seq += 1
        self.items_sent += 1
        return True

    def offer_many(self, items, start: int = 0, end=None) -> int:
        """Send a batch while credit allows; returns the count accepted."""
        n = (len(items) if end is None else end) - start
        credit = self.acked_seq + self.receive_window - self.sent_seq
        if n > credit:
            n = credit
        if n <= 0:
            return 0
        due = self.clock.now() + self.latency
        self._in_flight.extend((due, it) for it in items[start:start + n])
        self.sent_seq += n
        self.items_sent += n
        return n

    def remaining_capacity(self) -> int:
        return max(0, self.acked_seq + self.receive_window - self.sent_seq)

    def has_room_for(self, item) -> bool:
        """Transport contract (see ``SPSCQueue``): one credit == one item."""
        return self.sent_seq < self.acked_seq + self.receive_window

    # -- consumer side ---------------------------------------------------------
    def poll(self) -> Optional[Any]:
        if not self._recv:
            return None
        self._processed += 1
        return self._recv.popleft()

    def poll_prefix(self, limit: int, explode_blocks: bool = False):
        """Batched control-aware drain; see ``SPSCQueue.poll_prefix``."""
        recv = self._recv
        n = len(recv)
        if limit < n:
            n = limit
        if n <= 0:
            return (), None
        events = []
        append = events.append
        extend = events.extend
        popleft = recv.popleft
        ctrl = None
        consumed = 0
        while consumed < n:
            item = recv[0]
            cls = item.__class__
            if cls is EventBlock:
                if explode_blocks:
                    extend(item.to_events())
                else:
                    append(item)
            elif cls is Event or isinstance(item, Event):
                append(item)
            else:
                ctrl = item
                popleft()
                consumed += 1
                break
            popleft()
            consumed += 1
        self._processed += consumed
        return events, ctrl

    def peek(self) -> Optional[Any]:
        return self._recv[0] if self._recv else None

    def __len__(self):
        return len(self._recv)

    def is_empty(self) -> bool:
        # empty for the consumer; in-flight items are not yet visible
        return not self._recv

    def pending_anywhere(self) -> bool:
        return bool(self._recv) or bool(self._in_flight)

    # -- engine pump -------------------------------------------------------------
    def pump(self) -> bool:
        """Deliver due in-flight items; run the ack protocol. Returns True
        if anything moved (progress tracking for the idle detector)."""
        now = self.clock.now()
        progress = False
        while (self._in_flight
               and self._in_flight[0][0] <= now
               and len(self._recv) < self.recv_capacity):
            self._recv.append(self._in_flight.popleft()[1])
            progress = True
        if now - self._last_ack >= ACK_INTERVAL_S:
            self._send_ack(now)
            progress = True
        return progress

    def _send_ack(self, now: float) -> None:
        """Consumer -> producer ack: advances acked_seq and adapts the
        receive window to ~3x the per-interval processing rate."""
        consumed_total = self.sent_seq - len(self._in_flight) - len(self._recv)
        self.acked_seq = consumed_total
        if self._processed > 0:
            target = self._processed * WINDOW_FILL_FACTOR
            # exponential move toward target, clamped
            self.receive_window = max(
                MIN_RECEIVE_WINDOW,
                min(MAX_RECEIVE_WINDOW, (self.receive_window + target) // 2))
        self._processed = 0
        self._last_ack = now
