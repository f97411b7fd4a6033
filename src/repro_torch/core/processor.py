"""Jet processors: the custom logic of a DAG vertex.

A :class:`Processor` consumes items from an :class:`Inbox` and emits to an
:class:`Outbox`.  The owning tasklet refills the inbox from the inbound
queues, repeatedly calls :meth:`Processor.process` until the inbox drains,
and flushes the outbox downstream.  A processor must tolerate its outbox
rejecting items (bounded capacity == backpressure): it returns with items
still in the inbox and is called again later.

This mirrors ``com.hazelcast.jet.core.Processor`` including the snapshot
hooks used by the Chandy-Lamport protocol.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

from .events import DONE, Event, EventBlock, Watermark


class Inbox:
    """A batch of input items from one edge ordinal."""

    __slots__ = ("_items",)

    def __init__(self):
        self._items: deque = deque()

    def add(self, item):
        self._items.append(item)

    def extend(self, items):
        """Bulk-append a drained slice (the tasklet's batched refill)."""
        self._items.extend(items)

    def peek(self):
        return self._items[0] if self._items else None

    def poll(self):
        return self._items.popleft() if self._items else None

    def remove(self):
        self._items.popleft()

    def clear(self):
        self._items.clear()

    def __len__(self):
        return len(self._items)

    def __iter__(self) -> Iterator:
        return iter(self._items)

    def is_empty(self) -> bool:
        return not self._items


class Outbox:
    """Bounded emission buffer; ``offer`` returning False == backpressure.

    The tasklet drains the outbox into the outbound edge queues between
    ``process`` calls.  ``batch_limit`` bounds the number of items buffered
    per execution slice, which also bounds tasklet latency (a slice stays
    under ~1 ms of work, the paper's cooperative-yield budget).
    """

    __slots__ = ("_items", "_limit", "snapshot_queue")

    def __init__(self, batch_limit: int = 512):
        self._items: List[Any] = []
        self._limit = batch_limit
        # (key, value) pairs captured by save_to_snapshot(); drained by the
        # tasklet into the snapshot store.
        self.snapshot_queue: List[Tuple[Any, Any]] = []

    def offer(self, item) -> bool:
        items = self._items
        if len(items) >= self._limit:
            return False
        items.append(item)
        return True

    def space(self) -> int:
        """Slots left before the batch limit (bulk-emitting producers size
        their run to this instead of probing ``offer`` per item)."""
        return self._limit - len(self._items)

    def extend(self, items) -> None:
        """Bulk-append a pre-sized run (caller respects :meth:`space`)."""
        self._items.extend(items)

    def offer_to_snapshot(self, key, value) -> bool:
        self.snapshot_queue.append((key, value))
        return True

    def drain(self) -> List[Any]:
        items, self._items = self._items, []
        return items

    def __len__(self):
        return len(self._items)


class ProcessorContext:
    """Runtime info handed to a processor at init time."""

    __slots__ = (
        "vertex_name",
        "global_index",
        "local_index",
        "total_parallelism",
        "node_id",
        "node_count",
        "partition_ids",
        "partition_count",
        "clock",
        "logger",
    )

    def __init__(self, vertex_name: str, global_index: int, local_index: int,
                 total_parallelism: int, node_id: int, node_count: int,
                 partition_ids: Tuple[int, ...], partition_count=None,
                 clock=None, logger=None):
        self.vertex_name = vertex_name
        self.global_index = global_index
        self.local_index = local_index
        self.total_parallelism = total_parallelism
        self.node_id = node_id
        self.node_count = node_count
        # partitions owned by this processor instance (for keyed state)
        self.partition_ids = partition_ids
        # cluster-wide partition count (None when the embedding harness
        # does not partition state); lets a processor address partitions
        # it does NOT own, e.g. to replicate replay offsets everywhere
        self.partition_count = partition_count
        self.clock = clock
        self.logger = logger


class Processor:
    """Base processor. Subclasses override the hooks they need.

    **State declarations** — the snapshot contract is machine-checked
    (``python -m repro.analysis``, see ROADMAP "Machine-checked
    contracts"): every ``self.*`` attribute a subclass mutates on the hot
    path (``process`` / ``process_block`` / ``try_process_watermark`` /
    ``complete`` / ``complete_edge`` / ``poll_async``) must be written in
    :meth:`save_to_snapshot` and read back in
    :meth:`restore_from_snapshot` / :meth:`finish_snapshot_restore`, or
    be declared in one of two class-level sets:

    * ``EPHEMERAL_STATE`` — attributes that legitimately do NOT survive a
      restart (rebuilt lazily, drained before every barrier, re-derived
      from replay, or pure telemetry).  Declare them with a comment
      saying *why* losing them is correct;
    * ``SNAPSHOT_STATE`` — attributes that ARE saved/restored but under a
      transformed name or route the checker's reference scan cannot
      follow (e.g. ``TransactionalSink.pending`` restores into
      ``prepared``).

    Declarations are unioned along the inheritance chain.  Everything
    else unaccounted for is a ``snapshot-missing-save`` /
    ``snapshot-missing-restore`` finding and fails CI.
    """

    #: hot-path mutable attributes that deliberately do not survive a
    #: restart (see class docstring); checked by repro.analysis
    EPHEMERAL_STATE: frozenset = frozenset()

    #: hot-path mutable attributes saved/restored under a transformed
    #: name the checker cannot trace (see class docstring)
    SNAPSHOT_STATE: frozenset = frozenset()

    #: False for processors that make blocking calls; the engine then runs
    #: them on a dedicated non-cooperative thread (paper §3.2).
    is_cooperative = True

    #: True for processors whose ``process`` understands
    #: :class:`~repro_torch.core.events.EventBlock` items.  When False (the
    #: default) the owning tasklet explodes incoming blocks into per-event
    #: runs at the queue boundary, so a black-box processor keeps exact
    #: per-event semantics (the columnar fast path is opt-in per vertex).
    accepts_blocks = False

    def init(self, outbox: Outbox, ctx: ProcessorContext) -> None:
        self.outbox = outbox
        self.ctx = ctx

    # -- data path ----------------------------------------------------------
    def process(self, ordinal: int, inbox: Inbox) -> None:
        """Consume as much of the inbox as possible, emitting via outbox."""
        raise NotImplementedError

    def try_process_watermark(self, wm: Watermark) -> bool:
        """Return True when the watermark is fully handled and may be
        forwarded; False to be called again (backpressured emission)."""
        return True

    def complete_edge(self, ordinal: int) -> bool:
        """Called when an input edge is exhausted; True when done."""
        return True

    def complete(self) -> bool:
        """Called after ALL input edges are exhausted; return True when the
        processor has emitted everything (batch semantics)."""
        return True

    # -- snapshot hooks -------------------------------------------------------
    def save_to_snapshot(self) -> bool:
        """Emit state as (key, value) pairs via outbox.offer_to_snapshot.
        Return True when finished (may be re-called under backpressure)."""
        return True

    def restore_from_snapshot(self, items: Iterable[Tuple[Any, Any]]) -> None:
        """Reload state saved by :meth:`save_to_snapshot`."""

    def finish_snapshot_restore(self) -> None:
        """Called once after all snapshot items were restored."""

    def close(self) -> None:
        """Release resources at job end."""


# ---------------------------------------------------------------------------
# Built-in stateless processors (targets of the fusion planner)
# ---------------------------------------------------------------------------


class FusedFunctionProcessor(Processor):
    """Executes a fused chain of map/filter/flatMap functions.

    The pipeline planner collapses consecutive stateless stages into a single
    vertex running this processor — Jet's operator fusion (paper §3.1).  The
    chain is compiled once into a single Python closure so the per-event cost
    is one call, not one call per stage.

    When every step of the chain declares a block form the planner also
    hands over ``block_chain`` (EventBlock -> EventBlock | None) and the
    vertex becomes block-aware: whole blocks run as column ops, per-event
    cost drops to per-block cost.
    """

    def __init__(self, chain: Callable[[Event], Iterable[Event]],
                 block_chain: Optional[Callable] = None):
        # chain: Event -> iterable of Events (possibly empty)
        self._chain = chain
        self._block_chain = block_chain
        self.accepts_blocks = block_chain is not None

    def process(self, ordinal: int, inbox: Inbox) -> None:
        chain = self._chain
        ob = self.outbox
        out_items = ob._items
        limit = ob._limit
        # the tasklet segregates control items at the queue boundary, so the
        # inbox holds only data events: iterate the backing deque directly
        # and extend the outbox list in place (same emitted sequence as the
        # per-item offer loop; a flat_map may overshoot the batch limit by
        # its fan-out, which only shifts a batch boundary)
        items = inbox._items
        popleft = items.popleft
        extend = out_items.extend
        block_chain = self._block_chain
        if block_chain is None:
            while items:
                if len(out_items) >= limit:
                    return
                extend(chain(items[0]))
                popleft()
            return
        append = out_items.append
        while items:
            if len(out_items) >= limit:
                return
            item = items[0]
            if item.__class__ is EventBlock:
                out = block_chain(item)
                if out is not None and len(out):
                    append(out)
            else:
                extend(chain(item))
            popleft()


class MapProcessor(FusedFunctionProcessor):
    def __init__(self, fn: Callable[[Event], Event]):
        super().__init__(lambda ev: (fn(ev),))


class FilterProcessor(FusedFunctionProcessor):
    def __init__(self, pred: Callable[[Event], bool]):
        super().__init__(lambda ev: (ev,) if pred(ev) else ())


class FlatMapProcessor(FusedFunctionProcessor):
    def __init__(self, fn: Callable[[Event], Iterable[Event]]):
        super().__init__(fn)


class SinkProcessor(Processor):
    """Terminal vertex: hands events to a consumer callable.

    The consumer is typically a results collector (tests/benchmarks) or an
    external-system adapter (the reference's ``snapshot/sinks.py`` holds
    transactional and idempotent variants; not ported yet).
    """

    def __init__(self, consumer: Callable[[Event], None]):
        self._consumer = consumer

    def process(self, ordinal: int, inbox: Inbox) -> None:
        consumer = self._consumer
        items = inbox._items
        popleft = items.popleft
        while items:
            consumer(popleft())
