"""Sources and sinks.

* :class:`ListSource` — batch source over a fixed collection.
* :class:`PacedGeneratorSource` — streaming source that emits synthetic
  events on an ideal schedule (``rate`` events/second of *cluster clock*);
  any delay in actually emitting an event counts against the measured
  latency, exactly the paper's methodology (§7.1).  Deterministic in the
  sequence number, so it is replayable after restore on an unchanged
  topology.
* :class:`Journal` + :class:`JournalSource` — a partitioned, replayable,
  Kafka-like log.  Journal partitions are mapped onto the cluster's state
  partitions, so offsets snapshot/restore through the same consistent-hash
  routing as keyed state — sources stay aligned with the partition table
  across topology changes (node loss / elastic scale-out).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .events import Event, EventBlock, Watermark, MAX_TIME, MIN_TIME
from .processor import Inbox, Processor
from .watermark import EventTimePolicy

#: max events per EventBlock a block-mode source emits in one burst
SOURCE_BLOCK_EVENTS = 4096
#: bursts smaller than this run the scalar loop — numpy per-call overhead
#: beats object churn only once a burst has real width (a paced source at
#: a modest rate produces 1-2 due events per slice; the saturation /
#: catch-up path produces thousands)
SCALAR_BURST_CUTOFF = 48


class ListSource(Processor):
    """Batch source: instance *i* of *N* emits ``items[i::N]``."""

    #: batch cursor only — a finite ListSource is not replayable mid-run;
    #: a restarted batch job re-reads ``items`` from the beginning
    EPHEMERAL_STATE = frozenset({"_pos"})

    def __init__(self, items: Sequence, ts_fn: Optional[Callable] = None,
                 key_fn: Optional[Callable] = None):
        self.items = items
        self.ts_fn = ts_fn or (lambda v: 0)
        self.key_fn = key_fn or (lambda v: None)
        self._pos = None

    def complete(self) -> bool:
        if self._pos is None:
            self._pos = self.ctx.global_index
        items, step = self.items, self.ctx.total_parallelism
        while self._pos < len(items):
            v = items[self._pos]
            if not self.outbox.offer(Event(self.ts_fn(v), self.key_fn(v), v)):
                return False
            self._pos += step
        return True


class PacedGeneratorSource(Processor):
    """Streaming source paced against the cluster clock.

    ``gen_fn(seq) -> (ts_ms, key, value)`` must be deterministic; ``rate``
    is the aggregate events/second across all instances.  Event time starts
    at 0 (ms) and the paper's latency clock is ``emit_wall_time -
    ideal_time``; the engine exposes ``ideal_time`` via the event timestamp
    so sinks can compute end-to-end latency.
    """

    #: policy/_gen_block are rebuilt by _setup() after a restore; the
    #: frontier trio (_frontiers/_old_total/_replay_horizon) is DERIVED
    #: from restored ("gen", p) entries — a replay filter consumed as the
    #:  new topology passes the old horizon, never itself snapshotted.
    #: The durable cursor is (_seq, _start), saved replicated to every
    #: partition.
    EPHEMERAL_STATE = frozenset({
        "policy", "_gen_block", "_frontiers", "_old_total",
        "_replay_horizon",
    })

    def __init__(self, gen_fn: Callable[[int], Tuple[int, Any, Any]],
                 rate: float, max_events: Optional[int] = None,
                 wm_policy: Optional[Callable[[], EventTimePolicy]] = None,
                 wm_stride: int = 1, wm_lag: int = 0,
                 block_size: Optional[int] = None):
        self.gen_fn = gen_fn
        self.rate = rate
        self.max_events = max_events
        #: ``wm_lag``: shorthand for a bounded-out-of-orderness policy —
        #: REQUIRED ( >= max skew) when gen_fn emits disordered timestamps,
        #: or events behind the watermark get dropped as late downstream
        self.policy_factory = wm_policy or (
            lambda lag=wm_lag: EventTimePolicy(lag=lag))
        self.wm_stride = wm_stride
        #: columnar emission: ``None`` = auto (use ``gen_fn.gen_block``
        #: when available and the watermark policy is vectorizable),
        #: ``0`` = force the scalar per-event path, ``n`` = block cap
        self.block_size = block_size
        self._seq = None           # next seq for THIS instance
        self._start = None         # absolute schedule anchor (cluster clock)
        self.policy = None
        self._gen_block = None
        #: exact-replay filter after a restore that changed parallelism:
        #: old residue class -> first seq NOT yet emitted by the previous
        #: topology (events below their class frontier are skipped)
        self._frontiers = None
        self._old_total = 0
        self._replay_horizon = 0

    def _setup(self):
        if self._seq is None:      # a restore may have set the offset
            self._seq = self.ctx.global_index
        if self._start is None:    # a restore re-anchors to the ORIGINAL t0
            self._start = self.ctx.clock.now()
        self.policy = self.policy_factory()
        # columnar mode: the generator must offer a vectorized form and
        # the watermark policy must be the plain bounded-lag policy with
        # min_step == 1, whose per-event decisions ("emit on every strict
        # rise of the running-max timestamp") vectorize exactly
        if self.block_size != 0:
            gb = getattr(self.gen_fn, "gen_block", None)
            if gb is not None and type(self.policy) is EventTimePolicy \
                    and self.policy.min_step == 1:
                self._gen_block = gb

    def complete(self) -> bool:
        if self.policy is None:
            self._setup()
        if self._gen_block is not None:
            done = self._complete_block()
            if done is not None:
                return done
            # fall through: burst too small for the columnar path
        step = self.ctx.total_parallelism
        rate = self.rate
        clock, start = self.ctx.clock, self._start
        gen = self.gen_fn
        outbox = self.outbox
        observe = self.policy.observe
        max_events, wm_stride = self.max_events, self.wm_stride
        seq = self._seq
        try:
            while True:
                if max_events is not None and seq >= max_events:
                    return True
                # emit every event already due at this instant in one run —
                # one clock read and one outbox extend per burst instead of
                # one offer per event
                overdue = (clock.now() - start) * rate - seq
                if overdue < 0:
                    return False
                budget = int(overdue) // step + 1
                room = outbox.space()
                if room <= 0:
                    return False
                if budget > room:
                    budget = room
                if max_events is not None:
                    left = (max_events - seq + step - 1) // step
                    if budget > left:
                        budget = left
                buf = []
                append = buf.append
                unthrottled = wm_stride == 1
                last_ts = None
                frontiers = self._frontiers
                while budget > 0 and len(buf) < room:
                    budget -= 1
                    if frontiers is not None:
                        if seq >= self._replay_horizon:
                            frontiers = self._frontiers = None
                        else:
                            front = frontiers.get(seq % self._old_total)
                            if front is not None and seq < front:
                                # already emitted by the pre-restart
                                # topology: exact replay skips it
                                seq += step
                                continue
                    ts, key, value = gen(seq)
                    append(Event(ts, key, value))
                    seq += step
                    if ts != last_ts:
                        # observe() only reacts to a changed timestamp, so
                        # runs of equal-ts events skip the call entirely
                        last_ts = ts
                        wm = observe(ts)
                        if wm is not None and (
                                unthrottled
                                or (seq // step) % wm_stride == 0):
                            append(Watermark(wm))
                outbox.extend(buf)
                if max_events is not None and seq >= max_events:
                    return True
        finally:
            self._seq = seq

    def _complete_block(self) -> Optional[bool]:
        """One columnar burst: generate up to ``block_size`` due events as
        ONE EventBlock, split it at the exact positions the scalar loop
        would have emitted watermarks, and extend the outbox with
        ``[block, wm, block, ...]``.

        Returns True when the stream is exhausted, False when no further
        progress is possible this slice, or None to delegate a small burst
        (< SCALAR_BURST_CUTOFF events) to the scalar loop — tiny bursts
        are cheaper as plain Events than as 2-row numpy columns.
        """
        step = self.ctx.total_parallelism
        seq = self._seq
        max_events = self.max_events
        if max_events is not None and seq >= max_events:
            return True
        overdue = (self.ctx.clock.now() - self._start) * self.rate - seq
        if overdue < 0:
            return False
        room = self.outbox.space()
        if room <= 0:
            return False
        n = int(overdue) // step + 1
        cap = self.block_size or SOURCE_BLOCK_EVENTS
        if n > cap:
            n = cap
        if max_events is not None:
            left = (max_events - seq + step - 1) // step
            if n > left:
                n = left
        # an explicitly small block_size still gets blocks; only the auto
        # mode trades tiny bursts back to the scalar loop
        if n < min(SCALAR_BURST_CUTOFF, cap):
            return None
        seqs = seq + step * np.arange(n, dtype=np.int64)
        self._seq = seq + n * step
        if self._frontiers is not None:
            # exact replay after a parallelism change: drop seqs the old
            # topology already emitted (same rule as the scalar loop)
            if seq >= self._replay_horizon:
                self._frontiers = None
            else:
                fr = np.full(self._old_total, MIN_TIME, dtype=np.int64)
                for cls, front in self._frontiers.items():
                    fr[cls] = front
                seqs = seqs[seqs >= fr[seqs % self._old_total]]
                if not len(seqs):
                    return False
                n = len(seqs)
        blk = self._gen_block(seqs)
        ts = blk.ts
        pol = self.policy
        lag = pol.lag
        # watermark fire positions: every strict rise of the running-max
        # timestamp (EventTimePolicy with min_step == 1), optionally
        # throttled by wm_stride — identical to observe() per event.  The
        # running max is seeded with the policy's carried-over top so a
        # disordered burst starting below it cannot falsely fire
        prev_top = pol._top_ts
        top = np.maximum.accumulate(ts)
        if prev_top > MIN_TIME:
            np.maximum(top, prev_top, out=top)
        rising = np.empty(n, dtype=bool)
        rising[0] = int(ts[0]) > prev_top
        np.greater(top[1:], top[:-1], out=rising[1:])
        if self.wm_stride > 1:
            rising &= ((seqs // step + 1) % self.wm_stride) == 0
        pos = np.nonzero(rising)[0]
        # bound the ITEM count this burst appends (each fire position
        # costs one block slice + one watermark): when fires are dense,
        # cut the burst at the last watermark that fits the outbox room
        # and return the remainder to the schedule — the outbox batch
        # limit stays a real per-slice latency bound, as in scalar mode
        max_w = max(1, (room - 1) // 2)
        if len(pos) > max_w:
            cut = int(pos[max_w - 1]) + 1
            self._seq = int(seqs[cut])
            blk = blk.slice(0, cut)
            top = top[:cut]
            pos = pos[:max_w]
            n = cut
        # policy state advances regardless of stride throttling, exactly
        # like the scalar loop's unconditional observe()
        new_top = int(top[-1])
        if new_top > pol._top_ts:
            pol._top_ts = new_top
            pol._last_wm = new_top - lag
        if not len(pos):
            items: List[Any] = [blk]
        else:
            items = []
            append = items.append
            tops = top[pos].tolist()
            prev = 0
            for k, p in enumerate(pos.tolist()):
                if p + 1 > prev:
                    append(blk.slice(prev, p + 1))
                append(Watermark(tops[k] - lag))
                prev = p + 1
            if prev < n:
                append(blk.slice(prev, n))
        self.outbox.extend(items)
        if max_events is not None and self._seq >= max_events:
            return True
        return False

    # replay support: each instance's frontier entry is replicated to
    # EVERY state partition (the snapshot store keys entries by
    # (vertex, instance, key), so replicas from different instances
    # coexist on one partition).  Each entry records which residue class
    # (old global index / old total parallelism) the frontier belongs
    # to: after a restart that CHANGED parallelism, the new instances
    # skip exactly the seqs the old topology already emitted — exact
    # replay, not at-least-once residue-gap duplication.  Replicating to
    # all partitions (instead of only the owned ones) is what makes the
    # skip rule sound: a new instance owns only a slice of the
    # partitions, and under owned-only placement it could miss some old
    # instances' entries entirely — its ``base`` then started above an
    # unseen class's frontier and the seqs in between were silently
    # LOST.  With full replication every restored instance reconstructs
    # the complete frontier vector from any single partition it owns.
    def save_to_snapshot(self) -> bool:
        n = self.ctx.partition_count
        pids = range(n) if n else self.ctx.partition_ids
        for p in pids:
            self.outbox.offer_to_snapshot(
                ("gen", p),
                (self._seq, self._start, self.ctx.global_index,
                 self.ctx.total_parallelism))
        return True

    def snapshot_partition(self, skey):
        if isinstance(skey, tuple) and skey[0] == "gen":
            return skey[1]
        return None

    def restore_from_snapshot(self, items) -> None:
        seqs, starts = [], []
        frontiers = {}
        old_total = 0
        for (tag, _p), val in items:
            if tag != "gen" or not val:
                continue
            if val[0] is not None:
                seqs.append(val[0])
            if val[1] is not None:
                starts.append(val[1])
            if len(val) >= 4 and val[2] is not None and val[0] is not None:
                cls, tot = val[2], val[3]
                old_total = max(old_total, tot)
                if frontiers.get(cls, MIN_TIME) < val[0]:
                    frontiers[cls] = val[0]
        if seqs:
            base = min(seqs)
            total = self.ctx.total_parallelism
            idx = self.ctx.global_index
            # smallest seq >= base in this instance's residue class
            self._seq = base + ((idx - base) % total)
            if frontiers and old_total:
                self._frontiers = frontiers
                self._old_total = old_total
                self._replay_horizon = max(frontiers.values())
        if starts:
            # the cluster clock is monotonic across restarts: anchoring to
            # the original t0 keeps the ideal schedule (and therefore the
            # measured latency of replayed events) honest
            self._start = min(starts)


class Journal:
    """Shared, partitioned, replayable event log (stands in for Kafka)."""

    def __init__(self, n_partitions: int = 16):
        self.n_partitions = n_partitions
        self.partitions: List[List[Tuple[int, Any, Any]]] = [
            [] for _ in range(n_partitions)]

    def append(self, ts: int, key, value) -> None:
        self.partitions[hash(key) % self.n_partitions].append((ts, key, value))

    def extend(self, records: Iterable[Tuple[int, Any, Any]]) -> None:
        for ts, key, value in records:
            self.append(ts, key, value)

    def total(self) -> int:
        return sum(len(p) for p in self.partitions)


class JournalSource(Processor):
    """Replayable source over a :class:`Journal`.

    Journal partition *jp* is read by the instance that owns state
    partition *jp* (``ctx.partition_ids``), and its offset snapshots under
    partition *jp* — after a topology change, the new owner of *jp* finds
    exactly the offset it needs (paper §4.5 "replayable source").
    ``finite=True`` emits DONE at the end of the journal (batch replay);
    otherwise the source idles waiting for more data.
    """

    #: the durable replay cursor is _offsets (saved per journal
    #: partition); the watermark policy is rebuilt by _setup(), pacing
    #: (_start/_emitted) re-anchors to the cluster clock after a restart,
    #: and _idle_wm_sent re-derives from the (restored) assignment
    EPHEMERAL_STATE = frozenset({
        "policy", "_start", "_emitted", "_idle_wm_sent",
    })

    def __init__(self, journal: Journal, finite: bool = True,
                 wm_policy: Optional[Callable[[], EventTimePolicy]] = None,
                 rate: Optional[float] = None, wm_lag: int = 0):
        self.journal = journal
        self.finite = finite
        #: ``wm_lag``: bounded out-of-orderness allowance for disordered
        #: journals (see PacedGeneratorSource)
        self.policy_factory = wm_policy or (
            lambda lag=wm_lag: EventTimePolicy(lag=lag))
        #: events/second per instance, paced against the cluster clock
        #: (None = drain as fast as possible)
        self.rate = rate
        self._offsets = None       # jp -> next index
        self.policy = None
        self._idle_wm_sent = False
        self._emitted = 0
        self._start = None

    def _setup(self):
        self._offsets = {
            jp: 0 for jp in self.ctx.partition_ids
            if jp < self.journal.n_partitions}
        self.policy = self.policy_factory()
        self._start = self.ctx.clock.now()
        self._emitted = 0

    def _due_budget(self) -> int:
        if self.rate is None:
            return 1 << 30
        due = int((self.ctx.clock.now() - self._start) * self.rate)
        return max(0, due - self._emitted)

    def complete(self) -> bool:
        if self._offsets is None:
            self._setup()
        if not self._offsets:
            # no journal partitions assigned: don't hold back the coalesced
            # watermark downstream
            if not self._idle_wm_sent:
                if self.outbox.offer(Watermark(MAX_TIME)):
                    self._idle_wm_sent = True
            return self.finite
        # merge-read across partitions in event-time order: offsets may
        # differ per partition (replay!), and reading one partition to
        # exhaustion before the next would emit watermarks that make the
        # other partitions' events late (premature window emission).
        budget = self._due_budget()
        parts = self.journal.partitions
        while budget > 0:
            best_jp, best_ts = -1, None
            for jp, off in self._offsets.items():
                part = parts[jp]
                if off < len(part):
                    ts = part[off][0]
                    if best_ts is None or ts < best_ts:
                        best_jp, best_ts = jp, ts
            if best_jp < 0:
                return self.finite  # all partitions exhausted
            off = self._offsets[best_jp]
            ts, key, value = parts[best_jp][off]
            if not self.outbox.offer(Event(ts, key, value)):
                return False
            self._offsets[best_jp] = off + 1
            budget -= 1
            self._emitted += 1
            wm = self.policy.observe(ts)
            if wm is not None:
                if not self.outbox.offer(Watermark(wm)):
                    return False
        return False

    # -- replay protocol --------------------------------------------------------
    def save_to_snapshot(self) -> bool:
        for jp, off in self._offsets.items():
            self.outbox.offer_to_snapshot(("off", jp), off)
        return True

    def snapshot_partition(self, skey) -> Optional[int]:
        if isinstance(skey, tuple) and skey[0] == "off":
            return skey[1]
        return None

    def restore_from_snapshot(self, items) -> None:
        if self._offsets is None:
            self._setup()
        for (tag, jp), off in items:
            if tag == "off" and jp in self._offsets:
                self._offsets[jp] = max(self._offsets[jp], off)


class CollectorSink(Processor):
    """Collects events into a shared list; records arrival wall time for
    latency measurement: appends ``(wall_now, event)``."""

    #: the caller owns ``out`` (test/benchmark observability buffer);
    #: results are judged by the harness, not restored into the job
    EPHEMERAL_STATE = frozenset({"out"})

    def __init__(self, out: list, with_time: bool = False):
        self.out = out
        self.with_time = with_time

    # jetlint: disable=hot-path-unbounded-growth -- `out` is the harness's results buffer, bounded by the finite test/benchmark input and read only after the job ends
    def process(self, ordinal: int, inbox: Inbox) -> None:
        out, with_time = self.out, self.with_time
        if with_time:
            now = self.ctx.clock.now
            out.extend((now(), item) for item in inbox)
        else:
            out.extend(inbox)
        inbox.clear()
