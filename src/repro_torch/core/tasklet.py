"""Tasklets and the cooperative scheduler.

A :class:`ProcessorTasklet` adapts one processor instance to the cooperative
execution protocol: ``call()`` performs one short slice of work — drain some
input, run the processor, flush the outbox — and returns whether it made
progress.  A :class:`CooperativeWorker` owns a set of tasklets and steps
them round-robin, exactly the paper's "simply iterating over all tasklets
repeatedly works pretty well" (§3.2).

The tasklet also implements the two stream-protocol mechanisms that must be
engine-level, not processor-level:

* **watermark coalescing** across all input queues (min-rule), and
* **Chandy-Lamport barrier handling**: in exactly-once mode a queue that
  delivered barrier *n* is parked until every live input queue delivered
  barrier *n* (alignment), then the processor state is snapshotted and the
  barrier is forwarded; in at-least-once mode the first sighting snapshots
  immediately and nothing is parked.
"""

from __future__ import annotations

import pickle as _pickle
import time as _time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from .dag import PARTITION_COUNT, Routing, partitions_for_keys
from .events import (DONE, Barrier, DoneItem, Event, EventBlock, Watermark,
                     MIN_TIME)
from .processor import Inbox, Outbox, Processor
from .watermark import WatermarkCoalescer

#: max data items moved from one input queue per drain slice (the paper's
#: batch-at-a-time tasklet granularity; also bounds slice latency)
DRAIN_BATCH = 256
#: routing cache bound for partitioned collectors (key -> queue index)
ROUTE_CACHE_MAX = 8192

# tasklet lifecycle states
RUNNING = "running"
SAVING_SNAPSHOT = "saving_snapshot"
EMITTING_BARRIER = "emitting_barrier"
COMPLETING = "completing"
EMITTING_DONE = "emitting_done"
DONE_STATE = "done"

GUARANTEE_NONE = "none"
GUARANTEE_AT_LEAST_ONCE = "at_least_once"
GUARANTEE_EXACTLY_ONCE = "exactly_once"


class TaskletFailureError(Exception):
    """A processor raised out of its cooperative slice.

    The scheduler wraps the original exception so the execution substrate
    can tell *which* tasklet failed and route the event into failure
    detection (restart policy) instead of crashing the driver.  The
    original exception is chained as ``__cause__``."""

    def __init__(self, tasklet, cause: BaseException):
        super().__init__(f"tasklet {tasklet.name} failed: {cause!r}")
        self.tasklet = tasklet
        self.cause = cause


#: value types whose == / hash are content-based and process-independent
_ATOMIC_ID = (int, float, str, bytes, bool, type(None))


def _stable_id(v):
    """Content-based stand-in for one identity component.  Atomic values
    represent themselves; anything else is reduced to its pickle bytes
    (content-deterministic for the simple record types that flow through
    pipelines) — never the object's default repr/hash, whose embedded
    address would not survive a restart or a process boundary."""
    if type(v) in _ATOMIC_ID:
        return v
    try:
        return _pickle.dumps(v, protocol=4)
    except Exception:
        return repr(v)


def poison_identity(ev):
    """Stable, hashable identity of one event for poison-record
    quarantine: the same record must produce the same identity on every
    replay, in every process generation, so dead-letter filtering keyed
    on it survives restarts and cold starts."""
    return (ev.ts, _stable_id(ev.key), _stable_id(ev.value))


class InQueue:
    """One inbound queue (SPSC ring or the receiver side of a NetworkLink)
    plus its stream-protocol state."""

    __slots__ = ("q", "ordinal", "done", "parked_barrier", "seen_barrier",
                 "priority", "index")

    def __init__(self, q, ordinal: int, priority: int = 0):
        self.q = q
        self.ordinal = ordinal
        self.done = False
        #: position within the owning tasklet's ``in_queues`` (set by the
        #: tasklet; lets watermark/done handling skip an O(n) list.index)
        self.index = 0
        #: barrier id this queue is parked on (exactly-once alignment)
        self.parked_barrier: Optional[int] = None
        #: last barrier id delivered (at-least-once: no parking, but the
        #: snapshot still waits for the barrier on every live queue)
        self.seen_barrier: int = 0
        #: lower value drains first; higher-priority queues are not polled
        #: until every lower-value queue is done (hash-join build sides)
        self.priority = priority


class EdgeCollector:
    """Routes a tasklet's output items onto one out-edge's queues.

    ``queues[i]`` accepts ``offer(item) -> bool``; for distributed edges
    some of them are NetworkLink producers.  ``partition_to_queue`` maps a
    key partition to a queue index for PARTITIONED routing.  Control items
    (watermarks, barriers, DONE) are *broadcast* to every queue with
    resumable partial progress.
    """

    __slots__ = ("queues", "routing", "key_fn", "partition_to_queue",
                 "_rr_cursor", "_bc_item", "_bc_remaining", "_route_cache",
                 "_p2q_arr", "_blk_pending")

    def __init__(self, queues: Sequence, routing: str,
                 key_fn: Optional[Callable],
                 partition_to_queue: Optional[List[int]] = None):
        self.queues = list(queues)
        self.routing = routing
        self.key_fn = key_fn
        self.partition_to_queue = partition_to_queue
        self._rr_cursor = 0
        self._bc_item = None
        self._bc_remaining: List[int] = []
        #: key -> queue index memo (partitioned routing); bounded so a
        #: high-cardinality key space cannot grow it without limit
        self._route_cache: dict = {}
        #: vectorized partition->queue table (built on first block)
        self._p2q_arr = None
        #: (block, computed sub-blocks) awaiting all-or-nothing admission
        self._blk_pending = None

    # -- data items ---------------------------------------------------------
    def _queue_index_for(self, item) -> int:
        # canonical routing decision; offer_many's inner loop inlines this
        # body for speed — keep the two in sync
        key = self.key_fn(item) if self.key_fn else item.key
        cache = self._route_cache
        qi = cache.get(key)
        if qi is None:
            qi = self.partition_to_queue[hash(key) % PARTITION_COUNT]
            if len(cache) < ROUTE_CACHE_MAX:
                cache[key] = qi
        return qi

    def _offer_block(self, blk: EventBlock) -> bool:
        """Route one EventBlock onto a partitioned edge.

        The key column is hashed once (vectorized), rows are stably
        counting-sorted by destination queue, and each destination gets
        ONE sub-block with its rows in stream order — exactly the
        per-queue sequence the per-item protocol produces.  Delivery is
        all-or-nothing: every destination must have a free slot, else
        nothing is enqueued and the call retries later (the computed
        split is cached for the retry).
        """
        if not len(blk):
            return True
        pending = self._blk_pending
        if pending is not None and pending[0] is blk:
            parts = pending[1]
        else:
            if self.key_fn is None:
                pids = partitions_for_keys(blk.key)
            else:
                # a custom key extractor sees the EVENT (e.g. all_to_one's
                # constant key): materialize rows for it — rare path
                key_fn = self.key_fn
                pids = np.fromiter(
                    (hash(key_fn(ev)) % PARTITION_COUNT
                     for ev in blk.to_events()),
                    np.int64, len(blk))
            if self._p2q_arr is None:
                self._p2q_arr = np.asarray(self.partition_to_queue,
                                           dtype=np.int64)
            dests = self._p2q_arr[pids]
            first = dests[0]
            if (dests == first).all():
                parts = [(int(first), blk)]
            else:
                order = np.argsort(dests, kind="stable")
                sd = dests[order]
                starts = np.nonzero(
                    np.concatenate(([True], sd[1:] != sd[:-1])))[0]
                ends = np.append(starts[1:], len(sd))
                parts = [(int(sd[s]), blk.take(order[s:e]))
                         for s, e in zip(starts, ends)]
        qs = self.queues
        # every destination must guarantee admission of ITS sub-block before
        # anything is enqueued; has_room_for (not a slot count) is what makes
        # this sound on byte-capacity transports like the shm ring
        for qi, sub in parts:
            if not qs[qi].has_room_for(sub):
                self._blk_pending = (blk, parts)
                return False
        for qi, sub in parts:
            qs[qi].offer(sub)
        self._blk_pending = None
        return True

    def offer(self, item: Event) -> bool:
        r = self.routing
        if r == Routing.PARTITIONED:
            if item.__class__ is EventBlock:
                return self._offer_block(item)
            return self.queues[self._queue_index_for(item)].offer(item)
        if r == Routing.ROUND_ROBIN:
            n = len(self.queues)
            for i in range(n):
                qi = (self._rr_cursor + i) % n
                if self.queues[qi].offer(item):
                    self._rr_cursor = (qi + 1) % n
                    return True
            return False
        if r == Routing.ISOLATED:
            return self.queues[0].offer(item)
        # BROADCAST of data items uses the same resumable path as control
        return self.broadcast(item)

    def offer_control(self, item) -> bool:
        """Forward a control item emitted by a *source* outbox (watermark).

        On a keyed edge the item applies to every partition, so it is
        broadcast; otherwise it follows the same routing a data item would
        (the seed behaviour)."""
        if self.routing == Routing.PARTITIONED:
            return self.broadcast(item)
        return self.offer(item)

    def offer_many(self, items: List[Any], start: int = 0,
                   end: Optional[int] = None) -> int:
        """Route ``items[start:end]`` in order; returns the count accepted.

        Items are moved as runs: a contiguous stretch headed for the same
        destination queue is handed over in one bulk ``offer_many`` instead
        of one call per item.  Routing decisions are identical to
        :meth:`offer`, so a prefix accepted here equals the same prefix
        offered item-at-a-time.
        """
        r = self.routing
        qs = self.queues
        n = len(items) if end is None else end
        if start >= n:
            return 0
        if r == Routing.ISOLATED or len(qs) == 1 and r != Routing.BROADCAST:
            # single destination: routing cannot differ per item
            return qs[0].offer_many(items, start, n)
        if r == Routing.PARTITIONED:
            key_fn = self.key_fn
            p2q = self.partition_to_queue
            cache = self._route_cache
            cache_get = cache.get
            dest_of = self._queue_index_for
            i = start
            while i < n:
                item = items[i]
                if item.__class__ is EventBlock:
                    if not self._offer_block(item):
                        break
                    i += 1
                    continue
                qi = dest_of(item)
                j = i + 1
                while j < n:
                    nxt = items[j]
                    if nxt.__class__ is EventBlock:
                        break
                    key = key_fn(nxt) if key_fn is not None else nxt.key
                    q2 = cache_get(key)
                    if q2 is None:
                        q2 = p2q[hash(key) % PARTITION_COUNT]
                        if len(cache) < ROUTE_CACHE_MAX:
                            cache[key] = q2
                    if q2 != qi:
                        break
                    j += 1
                if j == i + 1:      # runs of one: plain offer is cheaper
                    if not qs[qi].offer(item):
                        break
                    i = j
                else:
                    run = j - i
                    accepted = qs[qi].offer_many(items, i, j)
                    i += accepted
                    if accepted < run:
                        break       # destination full: stop at this item
            return i - start
        # ROUND_ROBIN spreads per item and BROADCAST needs the resumable
        # per-item protocol: fall back to the exact item-at-a-time logic
        i = start
        if r == Routing.ROUND_ROBIN:
            while i < n and self.offer(items[i]):
                i += 1
        else:
            while i < n and self.broadcast(items[i]):
                i += 1
        return i - start

    # -- control items --------------------------------------------------------
    def broadcast(self, item) -> bool:
        """Offer ``item`` to every queue; resumable under backpressure.
        Only one broadcast may be in flight per collector at a time."""
        if self._bc_item is not item:
            self._bc_item = item
            self._bc_remaining = list(range(len(self.queues)))
        still = []
        for qi in self._bc_remaining:
            if not self.queues[qi].offer(item):
                still.append(qi)
        self._bc_remaining = still
        if not still:
            self._bc_item = None
            return True
        return False


class SnapshotContext:
    """Shared per-job snapshot coordination state (one per execution).

    A snapshot completes when every tasklet has either acked its barrier or
    become exempt (a tasklet whose inputs are exhausted will never see a
    barrier; its state is final and empty of in-flight work)."""

    __slots__ = ("guarantee", "requested_id", "writer", "tasklets", "_acked",
                 "completed_id", "on_complete", "terminal_requested",
                 "aborted_count")

    def __init__(self, guarantee: str, writer=None):
        self.guarantee = guarantee
        self.requested_id = 0       # bumped by the coordinator
        self.writer = writer        # SnapshotWriter (state backend)
        self.tasklets: List = []
        self._acked: set = set()
        self.completed_id = 0
        self.on_complete: Optional[Callable[[int], None]] = None
        self.terminal_requested = False
        #: snapshots abandoned without commit (barrier ack timeout, worker
        #: death mid-barrier); the last *committed* snapshot stays
        #: authoritative for recovery
        self.aborted_count = 0

    def check_timeout(self) -> bool:
        """Abort the in-flight snapshot if its barrier acks are overdue;
        returns True when an abort happened.  The in-process context acks
        via direct calls on this thread — a barrier here cannot be lost,
        only slow — so the base implementation never aborts.  Contexts
        whose acks cross a process boundary (``MpSnapshotContext``)
        override this with a real deadline."""
        return False

    def retire_aborted(self) -> None:
        """Destroy the IMap storage of a snapshot that began but will
        never commit (execution torn down mid-barrier).  Without this the
        partially-written ``__jet.snapshot.<job>.<id>`` map of every
        abandoned epoch leaks for the life of the cluster.  Idempotent;
        a no-op when nothing is in flight."""
        if self.writer is None or self.completed_id == self.requested_id:
            return
        self.writer.store._map(self.writer.job_id,
                               self.requested_id).destroy()

    def begin(self, snapshot_id: int) -> None:
        self.requested_id = snapshot_id
        self._acked = set()
        self._check()

    def ack(self, snapshot_id: int, tasklet) -> None:
        if snapshot_id != self.requested_id:
            return
        self._acked.add(id(tasklet))
        self._check()

    def notify_exempt(self, tasklet) -> None:
        """A tasklet entered a terminal phase; re-evaluate completion."""
        self._check()

    def _check(self) -> None:
        if self.completed_id == self.requested_id:
            return
        if all(id(t) in self._acked or t.is_snapshot_exempt
               for t in self.tasklets):
            self.completed_id = self.requested_id
            if self.on_complete is not None:
                self.on_complete(self.completed_id)


class ProcessorTasklet:
    """Drives one processor instance through the cooperative protocol."""

    def __init__(self, name: str, processor: Processor,
                 in_queues: List[InQueue],
                 collectors: List[EdgeCollector],
                 ssctx: SnapshotContext,
                 vertex_name: str,
                 global_index: int,
                 snapshot_pid_fn: Optional[Callable[[Any], int]] = None,
                 is_source: bool = False,
                 poison_ids: Optional[frozenset] = None,
                 pinpoint: bool = False):
        self.name = name
        self.processor = processor
        self.in_queues = in_queues
        self.collectors = collectors
        self.ssctx = ssctx
        self.vertex_name = vertex_name
        self.global_index = global_index
        self.is_source = is_source or not in_queues
        #: explode shim: a processor that does not declare
        #: ``accepts_blocks`` receives per-event explosions of any
        #: EventBlock (exploded at the queue boundary, where the drain's
        #: per-item type check already runs)
        self._explode_blocks = not getattr(processor, "accepts_blocks",
                                           False)
        #: quarantined record identities for this vertex (the engine's
        #: dead-letter escalation, see ``DeadLetterQueue``): events whose
        #: :func:`poison_identity` matches are dropped before the
        #: processor sees them
        self._poison_ids = frozenset(poison_ids) if poison_ids else None
        #: pinpoint mode: this vertex crashed before and the offending
        #: record is not yet known — the processor is fed ONE item per
        #: call so a recurrence is attributable to the exact in-flight
        #: record (``_process_pinpoint``)
        self._pinpoint = pinpoint
        if self._poison_ids is not None or pinpoint:
            # both modes need per-event granularity: a quarantined or
            # suspect record inside an EventBlock must be addressable
            self._explode_blocks = True
        #: events dropped by quarantine (dead-letter accounting checks)
        self.poison_dropped = 0
        #: optional non-blocking pump for processors driving asynchronous
        #: device work (core/device_window.py): called once per RUNNING
        #: slice even when no input is pending, so finished device futures
        #: are harvested without ever blocking the cooperative loop
        self._poll_async = getattr(processor, "poll_async", None)
        for i, iq in enumerate(in_queues):
            iq.index = i
        # per-ordinal inboxes
        max_ord = max((iq.ordinal for iq in in_queues), default=-1)
        self.inboxes = [Inbox() for _ in range(max_ord + 1)]
        #: running count of non-empty inboxes — kept in sync at the two
        #: places inboxes mutate (drain refills them, ``process`` consumes
        #: them) so the per-call "all inboxes empty?" checks are O(1)
        self._nonempty_inboxes = 0
        self.outbox = Outbox()
        #: flushed-but-not-yet-forwarded items (list + cursor: the batched
        #: flush consumes a prefix without per-item deque churn)
        self._pend_items: List[Any] = []
        self._pend_pos = 0
        self._pend_col = 0
        #: fan-out flush: per-collector count of items accepted beyond
        #: ``_pend_pos`` within the current data run (the shared cursor
        #: advances by the minimum)
        self._pend_col_offs: List[int] = [0] * len(collectors)
        self._pending_wm: Optional[Watermark] = None
        self._wm_processed = False
        self.coalescer = WatermarkCoalescer(len(in_queues)) if in_queues else None
        self.state = RUNNING
        self.snapshot_in_progress: Optional[int] = None
        #: snapshot id waiting for the inboxes to drain before it may start
        self._armed_snapshot: Optional[int] = None
        self.last_snapshot_id = 0
        self._snapshot_pid_fn = snapshot_pid_fn
        self._queue_cursor = 0
        self._barrier_to_emit: Optional[Barrier] = None
        #: fault injection (runtime/chaos.py): an exception planted here is
        #: raised at the top of the next slice, indistinguishable from the
        #: processor itself failing — the seam every chaos "raise" fault
        #: uses on both substrates
        self._chaos_exc: Optional[BaseException] = None
        # stats
        self.items_in = 0
        self.items_out = 0
        self.calls = 0
        self.idle_calls = 0

    # ------------------------------------------------------------------ call --
    def call(self) -> bool:
        """One execution slice; returns True when progress was made."""
        if self._chaos_exc is not None:
            exc, self._chaos_exc = self._chaos_exc, None
            raise exc
        self.calls += 1
        progress = False

        # 1. flush anything already produced
        if self._pend_pos < len(self._pend_items) or len(self.outbox):
            progress |= self._flush_outbox()
            if self._pend_pos < len(self._pend_items):
                self.idle_calls += not progress
                return progress

        # 2. pending watermark: only once every already-drained item has been
        #    processed (all data <= a coalesced watermark is in the inboxes
        #    by the time it advances, so this ordering is what makes window
        #    emission see complete frames)
        if self._pending_wm is not None and not self._nonempty_inboxes:
            if not self._forward_watermark():
                self.idle_calls += not progress
                return progress
            progress = True

        st = self.state
        if st == RUNNING:
            progress |= self._run_slice()
        elif st == SAVING_SNAPSHOT:
            progress |= self._save_snapshot_slice()
        elif st == EMITTING_BARRIER:
            progress |= self._emit_barrier_slice()
        elif st == COMPLETING:
            progress |= self._complete_slice()
        elif st == EMITTING_DONE:
            progress |= self._emit_done_slice()
        if not progress:
            self.idle_calls += 1
        return progress

    # -------------------------------------------------------------- running --
    def _run_slice(self) -> bool:
        progress = False
        # source tasklets: react to coordinator-initiated snapshots
        if self.is_source and self.ssctx.guarantee != GUARANTEE_NONE:
            if self.ssctx.requested_id > self.last_snapshot_id:
                self._begin_snapshot(self.ssctx.requested_id)
                return True

        if self.is_source:
            # streaming/batch sources do their work in complete()
            done = self.processor.complete()
            emitted = self._flush_outbox()
            progress |= emitted
            if done:
                self.state = EMITTING_DONE
                return True
            return progress

        progress |= self._drain_inputs()
        # run the processor over non-empty inboxes
        if self._nonempty_inboxes:
            for ordinal, inbox in enumerate(self.inboxes):
                before = len(inbox)
                if before:
                    if self._poison_ids is not None:
                        self._drop_quarantined(inbox)
                    if not len(inbox):
                        pass        # the whole batch was quarantined
                    elif self._pinpoint:
                        self._process_pinpoint(ordinal, inbox)
                    else:
                        self.processor.process(ordinal, inbox)
                    after = len(inbox)
                    if not after:
                        self._nonempty_inboxes -= 1
                    progress |= after != before or len(self.outbox) > 0
                    if len(self.outbox):
                        self._flush_outbox()
        # asynchronous-device processors: harvest finished futures (the
        # pump is non-blocking; device completions happen off-thread)
        if self._poll_async is not None:
            progress |= self._poll_async()
            if len(self.outbox):
                self._flush_outbox()
        # watermark became due after this slice's inbox processing
        if self._pending_wm is not None and not self._nonempty_inboxes:
            progress |= self._forward_watermark()
        # a snapshot armed by a barrier starts only once every pre-barrier
        # item has been fully processed and emitted (consistency of the cut)
        if (self._armed_snapshot is not None
                and not self._nonempty_inboxes
                and self._pend_pos >= len(self._pend_items)
                and not len(self.outbox)):
            sid = self._armed_snapshot
            self._armed_snapshot = None
            self._begin_snapshot(sid)
            return True
        # all inputs done?
        if (self.state == RUNNING and self.in_queues
                and not self._nonempty_inboxes
                and all(iq.done for iq in self.in_queues)):
            self.state = COMPLETING
            self.ssctx.notify_exempt(self)
            progress = True
        return progress

    def _drop_quarantined(self, inbox) -> None:
        """Filter dead-lettered records out of the inbox before the
        processor runs (exactly-once on the surviving stream: the
        quarantined record is accounted for in the engine's dead-letter
        queue, never processed, never lost twice)."""
        ids = self._poison_ids
        items = inbox._items
        kept = [it for it in items
                if not isinstance(it, Event) or poison_identity(it) not in ids]
        dropped = len(items) - len(kept)
        if dropped:
            self.poison_dropped += dropped
            items.clear()
            items.extend(kept)

    def _process_pinpoint(self, ordinal: int, inbox) -> None:
        """Feed the processor one item per call.  Some processors pop
        items only after a successful step, others pop first — so at a
        raise the inbox head is not a reliable culprit.  With exactly one
        item in the inbox there is no ambiguity: a raise stamps that
        record onto the exception (``_jet_poison``), which rides the
        failure report to the engine's escalation ladder."""
        items = inbox._items
        head = items[0]
        rest = None
        if len(items) > 1:
            items.popleft()
            rest = list(items)
            items.clear()
            items.append(head)
        try:
            self.processor.process(ordinal, inbox)
        except BaseException as exc:
            if (isinstance(head, Event)
                    and getattr(exc, "_jet_poison", None) is None):
                try:
                    exc._jet_poison = {"vertex": self.vertex_name,
                                       "identity": poison_identity(head),
                                       "record": repr(head),
                                       "exact": True}
                except AttributeError:      # exception types with __slots__
                    pass
            raise
        finally:
            if rest:
                items.extend(rest)

    def _drain_inputs(self) -> bool:
        """Drain input queues round-robin in batched slices.

        Data events move as one bulk ``poll_prefix`` per queue (the queue
        segregates the leading run of events from the first control item),
        so the per-item cost is one type check inside the queue instead of
        a poll/isinstance/add round-trip per item.  Control items are still
        handled one at a time, in arrival order, exactly as the seed
        item-at-a-time loop did.
        """
        progress = False
        in_queues = self.in_queues
        n = len(in_queues)
        exactly_once = self.ssctx.guarantee == GUARANTEE_EXACTLY_ONCE
        # priority edges: only drain the lowest not-yet-done priority class
        cur_priority = min((iq.priority for iq in in_queues
                            if not iq.done), default=0)
        cursor = self._queue_cursor
        inboxes = self.inboxes
        for i in range(n):
            iq = in_queues[(cursor + i) % n]
            if iq.done or iq.parked_barrier is not None:
                continue
            if iq.priority > cur_priority:
                continue
            events, ctrl = iq.q.poll_prefix(DRAIN_BATCH,
                                            self._explode_blocks)
            if events:
                progress = True
                self.items_in += len(events)
                inbox = inboxes[iq.ordinal]
                if not len(inbox):
                    self._nonempty_inboxes += 1
                inbox.extend(events)
            if ctrl is not None:
                progress = True
                if isinstance(ctrl, Watermark):
                    self._on_watermark(iq, ctrl)
                elif isinstance(ctrl, Barrier):
                    iq.seen_barrier = ctrl.snapshot_id
                    if exactly_once:
                        iq.parked_barrier = ctrl.snapshot_id
                    self._recheck_alignment(ctrl.snapshot_id)
                elif isinstance(ctrl, DoneItem):
                    self._on_queue_done(iq)
        self._queue_cursor = (cursor + 1) % max(n, 1)
        return progress

    # ------------------------------------------------------------ watermarks --
    def _on_watermark(self, iq: InQueue, wm: Watermark) -> None:
        new_ts = self.coalescer.observe(iq.index, wm.ts)
        if new_ts is not None:
            self._pending_wm = Watermark(new_ts)
            self._wm_processed = False

    def _forward_watermark(self) -> bool:
        wm = self._pending_wm
        if not self._wm_processed:
            if not self.processor.try_process_watermark(wm):
                self._flush_outbox()
                return False
            self._wm_processed = True
            self._flush_outbox()
        for c in self.collectors:
            if not c.broadcast(wm):
                return False
        self._pending_wm = None
        return True

    # -------------------------------------------------------------- barriers --
    def _recheck_alignment(self, snapshot_id: Optional[int] = None) -> None:
        """Arm the snapshot once barrier ``snapshot_id`` was delivered on
        every live queue.  Exactly-once additionally parks queues that are
        already past the barrier (done in ``_drain_inputs``); at-least-once
        keeps draining them, accepting replay-duplicates."""
        if snapshot_id is None:
            ids = [iq.seen_barrier for iq in self.in_queues
                   if not iq.done and iq.seen_barrier > self.last_snapshot_id]
            if not ids:
                return
            snapshot_id = min(ids)
        if snapshot_id <= self.last_snapshot_id:
            return
        live = [iq for iq in self.in_queues if not iq.done]
        if live and all(iq.seen_barrier >= snapshot_id for iq in live):
            self._armed_snapshot = snapshot_id

    def _begin_snapshot(self, snapshot_id: int) -> None:
        self.snapshot_in_progress = snapshot_id
        self.state = SAVING_SNAPSHOT

    def _save_snapshot_slice(self) -> bool:
        # transactional sinks key their prepared buffers by snapshot id
        self.processor.current_snapshot_id = self.snapshot_in_progress
        ok = self.processor.save_to_snapshot()
        # drain snapshotted state into the store
        writer = self.ssctx.writer
        if writer is not None:
            for key, value in self.outbox.snapshot_queue:
                pid = (self._snapshot_pid_fn(key)
                       if self._snapshot_pid_fn is not None else None)
                if pid is None:
                    pid = hash(key) % PARTITION_COUNT
                writer.put(self.snapshot_in_progress, self.vertex_name,
                           key, value, pid, instance=self.global_index)
        self.outbox.snapshot_queue.clear()
        self._flush_outbox()
        if ok:
            self._barrier_to_emit = Barrier(self.snapshot_in_progress)
            self.state = EMITTING_BARRIER
        return True

    def _emit_barrier_slice(self) -> bool:
        b = self._barrier_to_emit
        for c in self.collectors:
            if not c.broadcast(b):
                return True  # made progress, still emitting
        # barrier fully forwarded: unpark queues, ack, resume
        self.last_snapshot_id = b.snapshot_id
        for iq in self.in_queues:
            if iq.parked_barrier == b.snapshot_id:
                iq.parked_barrier = None
        self._barrier_to_emit = None
        self.snapshot_in_progress = None
        self.state = RUNNING
        self.ssctx.ack(b.snapshot_id, self)
        return True

    # ------------------------------------------------------------- done/batch --
    def _on_queue_done(self, iq: InQueue) -> None:
        iq.done = True
        new_ts = self.coalescer.queue_done(iq.index)
        if new_ts is not None:
            self._pending_wm = Watermark(new_ts)
            self._wm_processed = False
        ordinal_queues = [q for q in self.in_queues if q.ordinal == iq.ordinal]
        if all(q.done for q in ordinal_queues):
            self.processor.complete_edge(iq.ordinal)
        # a queue finishing can complete a pending barrier alignment
        if self.ssctx.guarantee != GUARANTEE_NONE:
            self._recheck_alignment()

    def _complete_slice(self) -> bool:
        done = self.processor.complete()
        self._flush_outbox()
        if done:
            self.state = EMITTING_DONE
        return True

    def _emit_done_slice(self) -> bool:
        for c in self.collectors:
            if not c.broadcast(DONE):
                return True
        self.state = DONE_STATE
        self.processor.close()
        self.ssctx.notify_exempt(self)
        return True

    # --------------------------------------------------------------- outbox --
    def _flush_outbox(self) -> bool:
        """Move outbox items to the edge collectors. Items go to every
        collector (one per out-edge); resumable under backpressure.

        Single out-edge (the overwhelmingly common shape) forwards the
        whole pending slice with one bulk ``offer_many``; fan-out keeps
        the per-item resumable protocol."""
        items, pos = self._pend_items, self._pend_pos
        if len(self.outbox):
            drained = self.outbox.drain()
            if pos >= len(items):
                items = self._pend_items = drained
                pos = self._pend_pos = 0
                self._pend_col = 0
            else:
                items.extend(drained)
        n = len(items)
        if pos >= n:
            return False
        collectors = self.collectors
        progress = False
        if len(collectors) == 1:
            c = collectors[0]
            if not self.is_source:
                # non-source outboxes hold only data events: pure bulk path
                accepted = c.offer_many(items, pos)
                if accepted:
                    progress = True
                    pos += accepted
                    self.items_out += accepted
            else:
                # a source outbox interleaves watermarks with events:
                # forward runs of events in bulk, control items one by one
                while pos < n:
                    item = items[pos]
                    cls = item.__class__
                    if (cls is Event or cls is EventBlock
                            or isinstance(item, (Event, EventBlock))):
                        j = pos + 1
                        while j < n:
                            nxt = items[j]
                            ncls = nxt.__class__
                            if not (ncls is Event or ncls is EventBlock
                                    or isinstance(nxt, (Event, EventBlock))):
                                break
                            j += 1
                        accepted = c.offer_many(items, pos, j)
                        if accepted:
                            progress = True
                            pos += accepted
                            self.items_out += accepted
                        if pos < j:
                            break
                    else:
                        if not c.offer_control(item):
                            break
                        progress = True
                        pos += 1
                        self.items_out += 1
        else:
            # fan-out: every item goes to every collector before the shared
            # cursor advances.  Runs of data events move in bulk per
            # collector with independent progress (``_pend_col_offs``); the
            # cursor advances by the minimum across collectors, so each
            # queue still sees the exact per-item sequence it would have
            # seen under the per-item protocol.
            offs = self._pend_col_offs
            n_cols = len(collectors)
            is_source = self.is_source
            if not n_cols:
                # terminal vertex with no out-edges: consume silently, the
                # behaviour of the per-item loop this path replaced
                self.items_out += n - pos
                pos = n
                progress = True
            while pos < n:
                item = items[pos]
                # a fused source with fan-out can interleave watermarks
                # here too: they must take the control route on keyed edges
                if is_source and not (item.__class__ is Event
                                      or item.__class__ is EventBlock
                                      or isinstance(item,
                                                    (Event, EventBlock))):
                    col = self._pend_col
                    blocked = False
                    while col < n_cols:
                        if not collectors[col].offer_control(item):
                            blocked = True
                            break
                        col += 1
                    self._pend_col = col
                    if blocked:
                        break
                    self._pend_col = 0
                    pos += 1
                    self.items_out += 1
                    progress = True
                    continue
                # maximal run of data events starting at pos
                if is_source:
                    j = pos + 1
                    while j < n and (items[j].__class__ is Event
                                     or items[j].__class__ is EventBlock
                                     or isinstance(items[j],
                                                   (Event, EventBlock))):
                        j += 1
                else:
                    j = n
                run = j - pos
                blocked = False
                for ci in range(n_cols):
                    if offs[ci] < run:
                        offs[ci] += collectors[ci].offer_many(
                            items, pos + offs[ci], j)
                        if offs[ci] < run:
                            blocked = True
                adv = min(offs)
                if adv:
                    pos += adv
                    for ci in range(n_cols):
                        offs[ci] -= adv
                    self.items_out += adv
                    progress = True
                if blocked:
                    break
        if pos >= n:
            self._pend_items = []
            self._pend_pos = 0
        else:
            self._pend_pos = pos
        return progress

    @property
    def is_done(self) -> bool:
        return self.state == DONE_STATE

    @property
    def is_snapshot_exempt(self) -> bool:
        """True when this tasklet can no longer receive a barrier: its
        inputs are exhausted (or it is a source that already finished)."""
        return self.state in (COMPLETING, EMITTING_DONE, DONE_STATE)

    def __repr__(self):  # pragma: no cover
        return f"Tasklet({self.name}, state={self.state})"


class CooperativeWorker:
    """One worker == one CPU core.  Steps its tasklets round-robin.

    Tracks per-tasklet wall time: a tasklet that hogs its slice (violating
    the paper's <1 ms cooperative budget) is a *straggler* — the report
    feeds the ops playbook (move the vertex to a non-cooperative thread, or
    in the active-active deployment simply prefer the healthy replica)."""

    __slots__ = ("tasklets", "name", "_time_in", "slice_budget_s",
                 "budget_violations", "_iterations")

    #: every iteration in this initial window is fully timed (catches
    #: stragglers in short-lived jobs before sampling kicks in)
    TIMING_WARMUP_ITERS = 512
    #: after warmup, one iteration in this many is timed; recorded time is
    #: scaled by the period so cumulative numbers stay comparable
    TIMING_SAMPLE_PERIOD = 32

    def __init__(self, name: str, slice_budget_s: float = 0.001):
        self.name = name
        self.tasklets: List[ProcessorTasklet] = []
        self._time_in: dict = {}
        self.slice_budget_s = slice_budget_s
        self.budget_violations: dict = {}
        self._iterations = 0

    def add(self, tasklet: ProcessorTasklet) -> None:
        self.tasklets.append(tasklet)

    def run_iteration(self) -> bool:
        """Step every live tasklet once.

        ``perf_counter`` pairs around every tasklet call used to be the
        scheduler's single biggest fixed cost; timing is now *sampled* —
        full coverage during a warmup window, then 1-in-N iterations —
        which keeps straggler detection while taking the clock calls off
        the steady-state hot path."""
        self._iterations = it = self._iterations + 1
        if it <= self.TIMING_WARMUP_ITERS:
            return self._run_iteration_timed(1)
        if not it % self.TIMING_SAMPLE_PERIOD:
            return self._run_iteration_timed(self.TIMING_SAMPLE_PERIOD)
        progress = False
        for t in self.tasklets:
            if not t.is_done:
                try:
                    progress |= t.call()
                except Exception as e:
                    raise TaskletFailureError(t, e) from e
        return progress

    def _run_iteration_timed(self, weight: int) -> bool:
        perf = _time.perf_counter
        time_in = self._time_in
        budget = self.slice_budget_s
        progress = False
        for t in self.tasklets:
            if not t.is_done:
                t0 = perf()
                try:
                    progress |= t.call()
                except Exception as e:
                    raise TaskletFailureError(t, e) from e
                dt = perf() - t0
                time_in[t.name] = time_in.get(t.name, 0.0) + dt * weight
                if dt > budget:
                    self.budget_violations[t.name] = \
                        self.budget_violations.get(t.name, 0) + 1
        return progress

    def hot_tasklets(self, top: int = 5):
        """(name, cumulative_s_estimate, budget_violations) sorted by time.
        Times are sampled estimates once the warmup window has passed."""
        return sorted(((n, s, self.budget_violations.get(n, 0))
                       for n, s in self._time_in.items()),
                      key=lambda x: -x[1])[:top]

    @property
    def all_done(self) -> bool:
        return all(t.is_done for t in self.tasklets)
