"""NEXMark queries on the Pipeline API.

The paper evaluates Q1, Q2, Q5, Q8 and Q13 (§7.1); Q3, Q4 and Q7 are
implemented as well to cover the benchmark's remaining patterns
(incremental two-sided join, join + windowed aggregate, global windowed
max).  Each builder takes source/sink suppliers and returns a
:class:`~repro_torch.core.pipeline.Pipeline`; window parameters default to the
paper's extreme configuration (10 s window, 10 ms slide).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..core.events import MIN_TIME, Event, Watermark, block_form
from ..core.pipeline import Pipeline
from ..core.processor import Inbox, Processor
from ..core.window import (AggregateOperation, averaging, co_aggregate,
                           counting, max_by, session, sliding, tumbling)
from .generator import KIND_BID
from .model import Auction, Bid, Person

USD_TO_EUR = 0.9


class IncrementalJoinProcessor(Processor):
    """Unwindowed streaming equi-join (NEXMark Q3's "incremental join"):
    both sides are retained per key; every arrival emits the new matches.
    Keyed + partitioned, state snapshotted for exactly-once."""

    def __init__(self, combine_fn: Callable, emit_left_once: bool = False):
        self.combine_fn = combine_fn
        self.left: Dict = {}        # key -> list (ordinal 0)
        self.right: Dict = {}       # key -> list (ordinal 1)

    def process(self, ordinal: int, inbox: Inbox) -> None:
        mine, other = ((self.left, self.right) if ordinal == 0
                       else (self.right, self.left))
        offer = self.outbox.offer
        while True:
            ev = inbox.peek()
            if ev is None:
                return
            matches = other.get(ev.key, ())
            ok = True
            for (mts, m) in matches:
                pair = (self.combine_fn(ev.value, m) if ordinal == 0
                        else self.combine_fn(m, ev.value))
                # emit at the LATER event time of the pair: arrival order
                # across the two sources is not ts-ordered, and downstream
                # windows key on the pair's completion time
                if not offer(Event(max(ev.ts, mts), ev.key, pair)):
                    ok = False
                    break
            if not ok:
                return
            # an unwindowed incremental join retains both sides forever by
            # definition (NEXMark Q3 semantics) — the retained state IS the
            # query's keyed state, snapshotted and partitioned above
            mine.setdefault(ev.key, []).append((ev.ts, ev.value))  # jetlint: disable=hot-path-unbounded-growth -- Q3's unwindowed join retains all history by definition; bounded by the benchmark's finite key domain
            inbox.remove()

    def save_to_snapshot(self) -> bool:
        # copy each side's match list: process() keeps appending to the
        # live lists between this barrier and the job-wide commit, and an
        # aliased payload would leak post-barrier matches into the
        # snapshot (restore extends, so a copy is contract-identical)
        for k, vs in self.left.items():
            self.outbox.offer_to_snapshot(("l", k), list(vs))
        for k, vs in self.right.items():
            self.outbox.offer_to_snapshot(("r", k), list(vs))
        return True

    def snapshot_partition(self, skey):
        from ..core.dag import PARTITION_COUNT
        return hash(skey[1]) % PARTITION_COUNT

    def restore_from_snapshot(self, items) -> None:
        for (side, k), vs in items:
            d = self.left if side == "l" else self.right
            d.setdefault(k, []).extend(vs)


def is_bid(v) -> bool:
    return isinstance(v, Bid)


# columnar forms over NEXMark generator blocks (the fusion planner lowers
# filter/rekey chains to these when the whole chain declares block forms;
# any other block shape explodes to events first, so these only ever see
# blocks carrying the generator's aux columns)
block_form(is_bid, lambda blk: blk.cols["kind"] == KIND_BID)

#: grouping key of a bid stream by auction — the generator's key column
#: already IS the auction id for bid rows
bid_auction = block_form(lambda b: b.auction, lambda blk: blk.key)

#: grouping key by bidder (NEXMark Q11's session key)
bid_bidder = block_form(lambda b: b.bidder, lambda blk: blk.cols["bidder"])

#: vectorized price getter for summing-style aggregates over bid streams
#: (scalar form reads the Event, like every AggregateOperation getter)
bid_price = block_form(lambda ev: ev.value.price, lambda blk: blk.value)


# ---------------------------------------------------------------------------
# Q1 — currency conversion (map)
# ---------------------------------------------------------------------------

def q1(source, sink) -> Pipeline:
    p = Pipeline.create()
    (p.read_from(source, name="bids")
        .filter(is_bid)
        .map(lambda b: Bid(b.auction, b.bidder, int(b.price * USD_TO_EUR),
                           b.ts))
        .write_to(sink))
    return p


# ---------------------------------------------------------------------------
# Q2 — selection (filter on auction id)
# ---------------------------------------------------------------------------

def q2(source, sink, mod: int = 123) -> Pipeline:
    p = Pipeline.create()
    (p.read_from(source, name="bids")
        .filter(is_bid)
        .filter(lambda b: b.auction % mod == 0)
        .map(lambda b: (b.auction, b.price))
        .write_to(sink))
    return p


# ---------------------------------------------------------------------------
# Q5 — hot items: auctions with the most bids in a sliding window
# ---------------------------------------------------------------------------

class MaxPerWindowProcessor(Processor):
    """Selects the max-count auction for each window_end (second level of
    Q5).  Keyed by window_end via a distributed partitioned edge."""

    def __init__(self):
        self.best: Dict[int, tuple] = {}

    def process(self, ordinal: int, inbox: Inbox) -> None:
        best = self.best
        get = best.get
        for ev in inbox:
            wr = ev.value
            cur = get(wr.window_end)
            if cur is None or wr.value > cur[1]:
                best[wr.window_end] = (wr.key, wr.value)
        inbox.clear()

    def try_process_watermark(self, wm: Watermark) -> bool:
        # strict: a result carries ts == w - 1 and items with ts == wm may
        # still arrive after the watermark
        ready = sorted(w for w in self.best if w - 1 < wm.ts)
        for w in ready:
            key, count = self.best[w]
            if not self.outbox.offer(Event(w - 1, key, (w, key, count))):
                return False
            del self.best[w]
        return True

    def complete(self) -> bool:
        for w in sorted(self.best):
            key, count = self.best[w]
            if not self.outbox.offer(Event(w - 1, key, (w, key, count))):
                return False
            del self.best[w]
        return True

    def save_to_snapshot(self) -> bool:
        for w, v in self.best.items():
            self.outbox.offer_to_snapshot(("best", w), v)
        return True

    def restore_from_snapshot(self, items) -> None:
        for (tag, w), v in items:
            if tag == "best":
                cur = self.best.get(w)
                if cur is None or v[1] > cur[1]:
                    self.best[w] = v


def q5(source, sink, window_ms: int = 10_000, slide_ms: int = 10,
       with_global_max: bool = False, placement: str = "host",
       device: Optional[Dict] = None) -> Pipeline:
    """Count bids per auction over a sliding window.

    ``with_global_max`` adds the "auction with most bids" second level; the
    paper's latency clock stops at window-result emission, so benchmarks use
    the two-stage aggregate output directly (the default).

    ``placement="device"`` swaps the host two-stage plan for the
    device-offloaded window vertex (EventBlocks pack into padded device
    batches, the compiled StreamExecutor aggregates) — same WindowResult
    stream, devices doing the math.  ``device`` forwards processor
    overrides; size ``n_key_buckets`` at or above the auction key space
    for per-auction-exact results.
    """
    p = Pipeline.create()
    counts = (p.read_from(source, name="bids")
                .filter(is_bid)
                .with_key(bid_auction)
                .window(sliding(window_ms, slide_ms))
                .aggregate(counting(), placement=placement, device=device))
    if with_global_max:
        (counts
            .rekey(lambda wr: wr.window_end)
            .custom_transform("max-per-window", MaxPerWindowProcessor,
                              partitioned=True, distributed=True)
            .write_to(sink))
    else:
        counts.write_to(sink)
    return p


# ---------------------------------------------------------------------------
# Q3 — who is selling in particular US states? (incremental join)
# ---------------------------------------------------------------------------

def q3(person_source, auction_source, sink,
       states=("OR", "ID", "CA"), category: int = 0) -> Pipeline:
    p = Pipeline.create()
    persons = (p.read_from(person_source, name="persons")
                 .filter(lambda v: isinstance(v, Person)
                         and v.state in states)
                 .rekey(lambda v: v.id))
    auctions = (p.read_from(auction_source, name="auctions")
                  .filter(lambda v: isinstance(v, Auction)
                          and v.category == category)
                  .rekey(lambda v: v.seller))
    join = _two_input_join(
        p, persons, auctions,
        lambda person, auction: (person.name, person.city, person.state,
                                 auction.id))
    join.write_to(sink)
    return p


def _two_input_join(p, left, right, combine_fn):
    """Wire a partitioned two-input IncrementalJoinProcessor (the planner
    lowers the "custom2" stage onto two distributed partitioned edges)."""
    from ..core.pipeline import GeneralStage, _Stage

    st = _Stage(p, "custom2", "inc_join", [left.stage, right.stage],
                {"supplier": lambda: IncrementalJoinProcessor(combine_fn)})
    return GeneralStage(p, st)


# ---------------------------------------------------------------------------
# Q4 — average closing price per category (join + windowed aggregate)
# ---------------------------------------------------------------------------

def q4(auction_source, bid_source, sink, window_ms: int = 10_000) -> Pipeline:
    """Join bids to their auction's category, then average the price per
    category over a tumbling window (the Beam simplification of Q4)."""
    p = Pipeline.create()
    auctions = (p.read_from(auction_source, name="auctions")
                  .filter(lambda v: isinstance(v, Auction))
                  .rekey(lambda v: v.id))
    bids = (p.read_from(bid_source, name="bids")
              .filter(is_bid)
              .rekey(lambda v: v.auction))
    joined = _two_input_join(p, auctions, bids,
                             lambda auction, bid: (auction.category,
                                                   bid.price))
    (joined
        .with_key(lambda cp: cp[0])
        .window(tumbling(window_ms))
        .aggregate(averaging(lambda ev: ev.value[1]))
        .write_to(sink))
    return p


# ---------------------------------------------------------------------------
# Q7 — highest bid per period (global tumbling max)
# ---------------------------------------------------------------------------

def q7(source, sink, window_ms: int = 10_000) -> Pipeline:
    p = Pipeline.create()
    (p.read_from(source, name="bids")
        .filter(is_bid)
        .with_key(lambda b: 0)                 # global key
        .window(tumbling(window_ms))
        .aggregate(max_by(lambda ev: ev.value.price))
        .write_to(sink))
    return p


# ---------------------------------------------------------------------------
# Q8 — monitor new users: persons who created auctions in the last period
# ---------------------------------------------------------------------------

def q8(person_source, auction_source, sink,
       window_ms: int = 10_000, slide_ms: int = 10) -> Pipeline:
    """Windowed join of new persons with their new auctions (co-aggregate:
    both sides collected per key per window, joined at export)."""
    def export_join(acc):
        persons, auctions = acc
        if persons and auctions:
            return (persons[0], list(auctions))
        return None

    op = co_aggregate(left=lambda ev: ev, right=lambda ev: ev)
    join_op = AggregateOperation(
        create=op.create, accumulate_fns=op.accumulate_fns,
        combine=op.combine, deduct=None, export=export_join)

    p = Pipeline.create()
    persons = (p.read_from(person_source, name="persons")
                 .filter(lambda v: isinstance(v, Person))
                 .with_key(lambda v: v.id))
    auctions = (p.read_from(auction_source, name="auctions")
                  .filter(lambda v: isinstance(v, Auction))
                  .with_key(lambda v: v.seller))
    (persons.window(sliding(window_ms, slide_ms))
        .aggregate2(auctions, join_op)
        .filter(lambda wr: wr.value is not None)
        .write_to(sink))
    return p


# ---------------------------------------------------------------------------
# Q11 — bids per user session (gap-based session windows)
# ---------------------------------------------------------------------------

def q11(source, sink, gap_ms: int = 10_000, allowed_lateness: int = 0,
        late_sink=None) -> Pipeline:
    """How many bids did each user make in each of their active sessions?
    The event-time-completeness showcase: session windows + allowed
    lateness + optional late-event side output, correct under disorder."""
    p = Pipeline.create()
    win = (p.read_from(source, name="bids")
             .filter(is_bid)
             .with_key(bid_bidder)
             .window(session(gap_ms))
             .allowed_lateness(allowed_lateness))
    if late_sink is not None:
        win = win.late_sink(late_sink)
    win.aggregate(counting()).write_to(sink)
    return p


# ---------------------------------------------------------------------------
# Q12 — bids per bidder per processing-time window
# ---------------------------------------------------------------------------

class ProcessingTimeWindowProcessor(Processor):
    """Tumbling *processing-time* window: frames are labelled by the
    cluster clock at ARRIVAL, so disorder in event time is irrelevant by
    construction (NEXMark Q12's defining property).  Emission is driven by
    the clock — checked whenever data or a watermark arrives — rather than
    by event-time watermarks."""

    #: frames ARE snapshotted, but restore routes them into the
    #: _restored epoch buffer (previous-clock-epoch frames flush as-is
    #: via finish_snapshot_restore, never merged with new-epoch frames),
    #: which the reference scan cannot see as a restore of ``frames``
    SNAPSHOT_STATE = frozenset({"frames"})
    #: _t0 anchors processing time and re-anchors after a restart by
    #: definition of processing time; _emit is flushed before barriers
    EPHEMERAL_STATE = frozenset({"_t0", "_emit"})

    def __init__(self, size_ms: int, op: AggregateOperation):
        from collections import deque
        self.size_ms = size_ms
        self.op = op
        self.frames: Dict = {}          # (key, frame_end_ms) -> acc
        self._t0: Optional[float] = None
        self._emit = deque()
        # frames from a restored snapshot (previous clock epoch); flushed
        # as-is by finish_snapshot_restore, never merged with new frames
        self._restored: Dict = {}

    def _now_ms(self) -> int:
        if self._t0 is None:
            self._t0 = self.ctx.clock.now()
        return int((self.ctx.clock.now() - self._t0) * 1000)

    def process(self, ordinal: int, inbox: Inbox) -> None:
        op, frames = self.op, self.frames
        acc_fn, create = op.accumulate, op.create
        size = self.size_ms
        fend = (self._now_ms() // size + 1) * size
        get = frames.get
        for ev in inbox:
            fkey = (ev.key, fend)
            acc = get(fkey)
            frames[fkey] = acc_fn(create() if acc is None else acc, ev)
        inbox.clear()
        self._emit_due()

    def _emit_due(self) -> None:
        now = self._now_ms()
        due = [kf for kf in self.frames if kf[1] <= now]
        due.sort(key=lambda kf: kf[1])
        export = self.op.export
        for key, fend in due:
            self._emit.append(
                Event(fend - 1, key,
                      (fend, key, export(self.frames.pop((key, fend))))))
        self._flush()

    def _flush(self) -> bool:
        while self._emit:
            if not self.outbox.offer(self._emit[0]):
                return False
            self._emit.popleft()
        return True

    def try_process_watermark(self, wm: Watermark) -> bool:
        # watermarks only serve as a liveness tick for the clock check
        self._emit_due()
        return self._flush()

    def complete(self) -> bool:
        # frames move into the emit queue unconditionally (popped as they
        # go, so re-calls under backpressure are safe); gating on a drained
        # queue would lose the final window of every key
        export = self.op.export
        for key, fend in sorted(self.frames, key=lambda kf: kf[1]):
            self._emit.append(
                Event(fend - 1, key,
                      (fend, key, export(self.frames.pop((key, fend))))))
        return self._flush()

    def save_to_snapshot(self) -> bool:
        # pre-barrier results stuck behind backpressure leave first
        if not self._flush():
            return False
        for (key, fend), acc in self.frames.items():
            self.outbox.offer_to_snapshot((key, fend), acc)
        return True

    def restore_from_snapshot(self, items) -> None:
        combine = self.op.combine
        for (key, fend), acc in items:
            cur = self._restored.get((key, fend))
            self._restored[(key, fend)] = (acc if cur is None
                                           else combine(cur, acc))

    def finish_snapshot_restore(self) -> None:
        # frame labels are epoch-relative (clock restarts at 0 after a
        # restore), so restored frames must NOT merge with the new epoch's
        # frames of the same label: their processing-time interval ended
        # with the old epoch — emit them immediately instead
        export = self.op.export
        for key, fend in sorted(self._restored, key=lambda kf: kf[1]):
            self._emit.append(
                Event(fend - 1, key,
                      (fend, key, export(self._restored.pop((key, fend))))))

    def snapshot_partition(self, skey):
        from ..core.dag import PARTITION_COUNT
        return hash(skey[0]) % PARTITION_COUNT


def q12(source, sink, window_ms: int = 10_000) -> Pipeline:
    """How many bids does each user make within a fixed *processing-time*
    window? (Uses the cluster clock, not event timestamps.)"""
    p = Pipeline.create()
    (p.read_from(source, name="bids")
        .filter(is_bid)
        .with_key(lambda b: b.bidder)
        .custom_transform(
            "q12-ptime-window",
            lambda: ProcessingTimeWindowProcessor(window_ms, counting()),
            partitioned=True, distributed=True)
        .write_to(sink))
    return p


# ---------------------------------------------------------------------------
# Q13 — bounded side-input join
# ---------------------------------------------------------------------------

def q13(bid_source, side_input_source, sink) -> Pipeline:
    """Enrich the bid stream against a bounded (batch) auction side input
    via a replicated hash join (Listing 2 pattern)."""
    p = Pipeline.create()
    side = (p.read_from(side_input_source, name="side-input")
              .filter(lambda v: isinstance(v, Auction)))
    (p.read_from(bid_source, name="bids")
        .filter(is_bid)
        .hash_join(side,
                   probe_key_fn=lambda b: b.auction,
                   build_key_fn=lambda a: a.id,
                   combine_fn=lambda b, a: (b, a))
        .write_to(sink))
    return p
