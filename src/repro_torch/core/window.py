"""Windowed aggregation: aggregate operations and the two-stage sliding
window processors.

Implements Jet's two-stage plan (paper §3.1): stage 1 runs on a *local*
partitioned edge and accumulates events into per-(key, frame) partial
accumulators; only closed frames travel over the *distributed* partitioned
edge to stage 2, which combines partial frames and emits window results.
Frames (panes) have the size of the window slide, so a sliding window is a
combine over ``size/slide`` frames — and with an invertible (``deduct``)
aggregate operation the running window result is maintained in O(1) per
frame, the low-latency sliding-window technique the paper references
[Tangwongsan et al., Traub et al.].

Snapshot keys are partitioned exactly like the data keys, so on restore
after a topology change each entry lands on the instance that now owns its
partition (Jet's partitioning-matches-state invariant, §4.1).  Window
emission progress is tracked *per key* so restores never duplicate or
corrupt already-emitted windows.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .events import (MAX_TIME, MIN_TIME, Event, EventBlock, LateEvent,
                     Watermark)
from .processor import Inbox, Processor


# ---------------------------------------------------------------------------
# Aggregate operations
# ---------------------------------------------------------------------------


class AggregateOperation:
    """create / accumulate / combine / (deduct) / export.

    ``accumulate_fns`` has one accumulate function per input ordinal
    (co-aggregation, Jet's AggregateOperation2/3).  ``deduct`` being present
    makes sliding windows O(1) per slide instead of O(size/slide).

    ``kind``/``block_get`` mark ops the columnar accumulate fast path can
    vectorize: ``kind='count'`` needs nothing else; ``kind='sum'``
    additionally needs ``block_get(block) -> ndarray`` — the vectorized
    form of the scalar getter (attached via
    :func:`~repro_torch.core.events.block_form`).  Everything else accumulates
    through the scalar path (blocks explode at the vertex boundary).
    """

    __slots__ = ("create", "accumulate_fns", "combine", "deduct", "export",
                 "kind", "block_get")

    def __init__(self, create: Callable[[], Any],
                 accumulate_fns: Tuple[Callable[[Any, Event], Any], ...],
                 combine: Callable[[Any, Any], Any],
                 deduct: Optional[Callable[[Any, Any], Any]],
                 export: Callable[[Any], Any],
                 kind: Optional[str] = None,
                 block_get: Optional[Callable] = None):
        self.create = create
        self.accumulate_fns = accumulate_fns
        self.combine = combine
        self.deduct = deduct
        self.export = export
        self.kind = kind
        self.block_get = block_get

    @property
    def accumulate(self):
        return self.accumulate_fns[0]


def counting() -> AggregateOperation:
    return AggregateOperation(
        create=lambda: 0,
        accumulate_fns=(lambda acc, ev: acc + 1,),
        combine=lambda a, b: a + b,
        deduct=lambda a, b: a - b,
        export=lambda acc: acc,
        kind="count",
    )


def summing(get: Callable[[Event], float]) -> AggregateOperation:
    return AggregateOperation(
        create=lambda: 0,
        accumulate_fns=(lambda acc, ev: acc + get(ev),),
        combine=lambda a, b: a + b,
        deduct=lambda a, b: a - b,
        export=lambda acc: acc,
        kind="sum",
        block_get=getattr(get, "__block_form__", None),
    )


def averaging(get: Callable[[Event], float]) -> AggregateOperation:
    return AggregateOperation(
        create=lambda: (0, 0),
        accumulate_fns=(lambda acc, ev: (acc[0] + get(ev), acc[1] + 1),),
        combine=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        deduct=lambda a, b: (a[0] - b[0], a[1] - b[1]),
        export=lambda acc: acc[0] / acc[1] if acc[1] else 0.0,
    )


def max_by(get: Callable[[Event], Any]) -> AggregateOperation:
    """Keeps the event value maximizing ``get``. Not invertible."""
    def acc_fn(acc, ev):
        m = get(ev)
        if acc is None or m > acc[0]:
            return (m, ev.value)
        return acc

    return AggregateOperation(
        create=lambda: None,
        accumulate_fns=(acc_fn,),
        combine=lambda a, b: b if a is None else a if b is None else max(a, b),
        deduct=None,
        export=lambda acc: None if acc is None else acc[1],
    )


def to_list() -> AggregateOperation:
    return AggregateOperation(
        create=lambda: [],
        accumulate_fns=(lambda acc, ev: (acc.append(ev.value) or acc),),
        combine=lambda a, b: a + b,
        deduct=None,
        export=lambda acc: list(acc),
    )


def co_aggregate(left: Callable[[Event], Any] = lambda ev: ev.value,
                 right: Callable[[Event], Any] = lambda ev: ev.value
                 ) -> AggregateOperation:
    """Two-input aggregation collecting both sides (windowed join substrate)."""
    def acc0(acc, ev):
        acc[0].append(left(ev))
        return acc

    def acc1(acc, ev):
        acc[1].append(right(ev))
        return acc

    return AggregateOperation(
        create=lambda: ([], []),
        accumulate_fns=(acc0, acc1),
        combine=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        deduct=None,
        export=lambda acc: acc,
    )


# ---------------------------------------------------------------------------
# Window definitions
# ---------------------------------------------------------------------------


class SlidingWindowDef:
    """Window of ``size`` sliding by ``slide``; size % slide == 0.

    Frames are labelled by their *end* timestamp; an event with timestamp
    ``ts`` belongs to the frame ending at ``higher_frame_ts(ts)``.  The
    window ending at W covers frames (W - size, W].
    """

    __slots__ = ("size", "slide")

    def __init__(self, size: int, slide: int):
        if size <= 0 or slide <= 0 or size % slide:
            raise ValueError("need size > 0, slide > 0, size % slide == 0")
        self.size = size
        self.slide = slide

    def higher_frame_ts(self, ts: int) -> int:
        return (ts // self.slide + 1) * self.slide

    @property
    def frames_per_window(self) -> int:
        return self.size // self.slide


def tumbling(size: int) -> SlidingWindowDef:
    return SlidingWindowDef(size, size)


def sliding(size: int, slide: int) -> SlidingWindowDef:
    return SlidingWindowDef(size, slide)


class SessionWindowDef:
    """Gap-based session windows: events of one key closer than ``gap``
    belong to the same session; a session closes when the watermark passes
    its end (last event time + gap)."""

    __slots__ = ("gap",)

    def __init__(self, gap: int):
        if gap <= 0:
            raise ValueError("need gap > 0")
        self.gap = gap


def session(gap: int) -> SessionWindowDef:
    return SessionWindowDef(gap)


# ---------------------------------------------------------------------------
# Stage 1: accumulate events into per-(key, frame) partial accumulators
# ---------------------------------------------------------------------------


class AccumulateByFrameProcessor(Processor):
    """Local partial aggregation (first of the two stages).

    Emits ``Event(ts=frame_end - 1, key, (frame_end, partial_acc))`` for
    every frame closed by a watermark; open frames are retained and
    snapshotted.

    **Allowed lateness**: a frame stays admissible for ``allowed_lateness``
    event-time past the watermark.  Events landing in an already-closed but
    still-admissible frame accumulate into a fresh *delta* partial that is
    emitted at the next watermark — the combiner re-fires the affected
    windows with updated totals.  Events later than that are counted in
    ``late_dropped`` and, with ``late_output``, wrapped in
    :class:`~repro_torch.core.events.LateEvent` for the late side output.
    """

    #: _last_wm is deliberately NOT snapshotted (see save_to_snapshot:
    #: a restored lateness horizon would drop replayed data); _emit_buf
    #: is flushed before every barrier by construction; late_dropped is
    #: telemetry, not replayable state
    EPHEMERAL_STATE = frozenset({"_last_wm", "_emit_buf", "late_dropped"})

    def __init__(self, wdef: SlidingWindowDef, op: AggregateOperation,
                 ordinal_map: Optional[Dict[int, int]] = None,
                 allowed_lateness: int = 0, late_output: bool = False):
        self.wdef = wdef
        self.op = op
        # input edge ordinal -> accumulate_fn index (for co-aggregation)
        self.ordinal_map = ordinal_map or {}
        # (key, frame_ts) -> acc
        self.frames: Dict[Tuple[Any, int], Any] = {}
        self._emit_buf: deque = deque()
        self.allowed_lateness = allowed_lateness
        self.late_output = late_output
        #: events that arrived too late to be admissible (deliberate drops)
        self.late_dropped = 0
        self._last_wm = MIN_TIME
        #: columnar fast path: counting (needs nothing) and summing (needs
        #: a vectorized getter) vectorize per block; co-aggregation keeps
        #: the scalar path (two accumulate fns, object accumulators)
        self.accepts_blocks = (
            not self.ordinal_map
            and (op.kind == "count"
                 or (op.kind == "sum" and op.block_get is not None)))

    def process(self, ordinal: int, inbox: Inbox) -> None:
        acc_fn = self.op.accumulate_fns[self.ordinal_map.get(ordinal, 0)]
        frames, slide = self.frames, self.wdef.slide
        create = self.op.create
        get = frames.get
        # frames at or below the horizon can no longer re-fire
        horizon = self._last_wm - self.allowed_lateness
        # accumulation never backpressures: consume the whole batch in one
        # pass over the inbox (only data events reach a processor's inbox);
        # higher_frame_ts is inlined — it runs once per event
        for ev in inbox:
            if ev.__class__ is EventBlock:
                self._accumulate_block(ev, horizon)
                continue
            fts = (ev.ts // slide + 1) * slide
            if fts <= horizon:
                # frame's lateness horizon passed: deliberate drop, not the
                # silent re-emission the pre-lateness code did
                self.late_dropped += 1
                if self.late_output:
                    le = LateEvent(ev.ts, ev.key, ev.value)
                    if not self.outbox.offer(le):
                        self._emit_buf.append(le)
                continue
            fkey = (ev.key, fts)
            acc = get(fkey)
            frames[fkey] = acc_fn(create() if acc is None else acc, ev)
        inbox.clear()

    def _accumulate_block(self, blk: EventBlock, horizon: int) -> None:
        """Columnar accumulate: frame assignment by floor-divide on the ts
        column, per-(key, frame) partial aggregation by a stable lexsort +
        segment reduce.  Within one (key, frame) group rows stay in stream
        order, so integer sums and counts are bit-identical to the scalar
        path; the only reassociation is the single ``combine`` of the
        block partial into the running accumulator."""
        op = self.op
        slide = self.wdef.slide
        ts, keys = blk.ts, blk.key
        if not len(ts):
            return
        fts = (ts // slide + 1) * slide
        weights = None
        if op.kind == "sum":
            weights = np.asarray(op.block_get(blk))
        late = fts <= horizon
        if late.any():
            late_idx = np.nonzero(late)[0]
            self.late_dropped += len(late_idx)
            if self.late_output:
                for i in late_idx.tolist():
                    le = LateEvent(int(ts[i]), int(keys[i]), blk.value_at(i))
                    if not self.outbox.offer(le):
                        self._emit_buf.append(le)
            keep = np.nonzero(~late)[0]
            if not len(keep):
                return
            keys, fts = keys[keep], fts[keep]
            if weights is not None:
                weights = weights[keep]
        order = np.lexsort((fts, keys))
        ks, fs = keys[order], fts[order]
        starts = np.nonzero(np.concatenate(
            ([True], (ks[1:] != ks[:-1]) | (fs[1:] != fs[:-1]))))[0]
        if weights is None:
            sums = np.diff(np.append(starts, len(ks)))
        else:
            sums = np.add.reduceat(weights[order], starts)
        frames = self.frames
        get = frames.get
        combine = op.combine
        gk, gf = ks[starts].tolist(), fs[starts].tolist()
        for i, part in enumerate(sums.tolist()):
            fkey = (gk[i], gf[i])
            cur = get(fkey)
            frames[fkey] = part if cur is None else combine(cur, part)

    def _flush(self) -> bool:
        buf = self._emit_buf
        while buf:
            if not self.outbox.offer(buf[0]):
                return False
            buf.popleft()
        return True

    def try_process_watermark(self, wm: Watermark) -> bool:
        # leftovers (backpressured LateEvents) go out first: the close work
        # below must still happen for THIS watermark afterwards, or the
        # forwarded watermark would overtake its closed frames
        if not self._flush():
            return False
        if wm.ts > self._last_wm:       # close exactly once per watermark
            self._last_wm = wm.ts
            buf = self._emit_buf
            closed = [(k, f) for (k, f) in self.frames if f <= wm.ts]
            closed.sort(key=lambda kf: kf[1])
            for key, fts in closed:
                buf.append(Event(fts - 1, key, (fts, self.frames.pop((key, fts)))))
        return self._flush()

    def complete(self) -> bool:
        if not self._flush():
            return False
        # batch semantics: flush every open frame
        for (key, fts), acc in sorted(self.frames.items(),
                                      key=lambda kv: kv[0][1]):
            if not self.outbox.offer(Event(fts - 1, key, (fts, acc))):
                return False
            del self.frames[(key, fts)]
        return True

    # -- snapshots ------------------------------------------------------------
    def save_to_snapshot(self) -> bool:
        # pre-barrier outputs stuck in the emit buffer (backpressured
        # LateEvents) must leave before the barrier, or a restore loses them
        if not self._flush():
            return False
        for (key, fts), acc in self.frames.items():
            self.outbox.offer_to_snapshot((key, fts), acc)
        # _last_wm is deliberately NOT snapshotted: replay (at-least-once
        # especially) re-delivers events from behind the snapshot watermark
        # that must re-accumulate, so the lateness horizon rebuilds from
        # the replayed stream's own watermarks.  Transiently admitting a
        # borderline-late event only re-fires a window with a more complete
        # value; a restored horizon would DROP replayed data.
        return True

    def restore_from_snapshot(self, items) -> None:
        for (key, fts), acc in items:
            cur = self.frames.get((key, fts))
            self.frames[(key, fts)] = (acc if cur is None
                                       else self.op.combine(cur, acc))

    def snapshot_partition(self, skey):
        # partition by the event key so restore follows the data partitions
        from .dag import PARTITION_COUNT
        return hash(skey[0]) % PARTITION_COUNT


# ---------------------------------------------------------------------------
# Stage 2: combine partial frames, maintain sliding windows, emit results
# ---------------------------------------------------------------------------


class WindowResult:
    __slots__ = ("window_end", "key", "value")

    def __init__(self, window_end: int, key, value):
        self.window_end = window_end
        self.key = key
        self.value = value

    def __repr__(self):  # pragma: no cover
        return (f"WindowResult(end={self.window_end}, key={self.key!r}, "
                f"value={self.value!r})")


class _KeyState:
    __slots__ = ("max_frame", "last_emitted", "running", "ring")

    def __init__(self):
        self.max_frame = MIN_TIME
        self.last_emitted = MIN_TIME
        # deduct fast path: running window accumulator + in-window frame ring
        self.running = None
        self.ring: Optional[Dict[int, Any]] = None


class CombineFramesProcessor(Processor):
    """Global combine (second stage) + window emission.

    Receives ``(frame_ts, partial_acc)`` events over the distributed
    partitioned edge.  With a ``deduct``-capable op it keeps a running
    window accumulator per key: each slide adds the entering frames and
    deducts the leaving ones — O(1) amortized per (key, slide) instead of
    recombining ``size/slide`` frames.
    """

    #: next_win_end is re-derived by restore_from_snapshot from the
    #: restored frames/rings (min open frame + slide); _emit_buf is
    #: flushed before every barrier by construction
    EPHEMERAL_STATE = frozenset({"next_win_end", "_emit_buf"})

    def __init__(self, wdef: SlidingWindowDef, op: AggregateOperation,
                 use_deduct: Optional[bool] = None,
                 allowed_lateness: int = 0, skip_late: bool = False):
        self.wdef = wdef
        self.op = op
        #: lateness disables the O(1) deduct path: re-firing a window needs
        #: its full frame set recombined, so frames must be retained (not
        #: folded into a running accumulator) until the lateness horizon
        self.allowed_lateness = allowed_lateness
        self.use_deduct = (op.deduct is not None if use_deduct is None
                           else (use_deduct and op.deduct is not None))
        if allowed_lateness > 0:
            self.use_deduct = False
        #: drop LateEvents travelling on the shared accumulate->combine
        #: edge when a late side output is wired upstream
        self.skip_late = skip_late
        self.frames: Dict[Tuple[Any, int], Any] = {}   # (key, frame) -> acc
        self.key_state: Dict[Any, _KeyState] = {}
        self.next_win_end: Optional[int] = None        # next W to consider
        self._emit_buf: deque = deque()
        #: (key, window_end) pairs whose result must be re-emitted because a
        #: late delta partial arrived after the window fired
        self._refire: set = set()

    # -- ingest ----------------------------------------------------------------
    def process(self, ordinal: int, inbox: Inbox) -> None:
        frames, combine = self.frames, self.op.combine
        key_state = self.key_state
        lateness = self.allowed_lateness
        skip_late = self.skip_late
        size, slide = self.wdef.size, self.wdef.slide
        for ev in inbox:
            if skip_late and isinstance(ev, LateEvent):
                continue
            fts, acc = ev.value
            ks = key_state.get(ev.key)
            if ks is None:
                ks = key_state[ev.key] = _KeyState()
            fkey = (ev.key, fts)
            cur = frames.get(fkey)
            frames[fkey] = acc if cur is None else combine(cur, acc)
            if fts > ks.max_frame:
                ks.max_frame = fts
            if lateness and fts <= ks.last_emitted:
                # late delta: every window covering this frame whose
                # emission point already passed re-fires with the updated
                # total (including windows that fired empty — the emission
                # loop's last_emitted guard would otherwise skip them).
                # NOT rewinding next_win_end here: the refire set covers
                # the emitted range, and a rewind would make the next
                # emission pass re-walk every slide from here to the front
                w = fts
                last = min(ks.last_emitted, fts + size - slide)
                while w <= last:
                    self._refire.add((ev.key, w))
                    w += slide
            elif self.next_win_end is None or fts < self.next_win_end:
                # earliest window this frame participates in
                self.next_win_end = fts
        inbox.clear()

    # -- window emission --------------------------------------------------------
    def _window_value(self, key, ks: _KeyState, w_end: int):
        """Combined accumulator for (key, window ending at w_end) or None."""
        op, frames = self.op, self.frames
        size, slide = self.wdef.size, self.wdef.slide
        if self.use_deduct:
            # move entering frames into the ring / running acc
            if ks.ring is None:
                ks.ring = {}
            # frames entering the window since this key's last emission
            lo_new = max(ks.last_emitted, w_end - size)
            f = lo_new + slide
            while f <= w_end:
                part = frames.pop((key, f), None)
                if part is not None:
                    if f in ks.ring:
                        ks.ring[f] = op.combine(ks.ring[f], part)
                    else:
                        ks.ring[f] = part
                    ks.running = (part if ks.running is None
                                  else op.combine(ks.running, part))
                f += slide
            # deduct frames that left the window
            lo = w_end - size
            for fts in [t for t in ks.ring if t <= lo]:
                ks.running = op.deduct(ks.running, ks.ring.pop(fts))
            if not ks.ring:
                ks.running = None
                return None
            return ks.running
        # general path: recombine the size/slide frames
        acc = None
        f = w_end - size + slide
        while f <= w_end:
            part = frames.get((key, f))
            if part is not None:
                acc = part if acc is None else op.combine(acc, part)
            f += slide
        return acc

    def _emit_refires(self) -> None:
        """Re-emit updated results for windows hit by late delta frames."""
        if not self._refire:
            return
        op = self.op
        for key, w in sorted(self._refire, key=lambda kw: kw[1]):
            ks = self.key_state.get(key)
            if ks is None:
                continue
            acc = self._window_value(key, ks, w)
            if acc is not None:
                self._emit_buf.append(
                    Event(w - 1, key, WindowResult(w, key, op.export(acc))))
        self._refire.clear()

    def _emit_windows_up_to(self, up_to: int) -> None:
        self._emit_refires()
        if self.next_win_end is None:
            return
        slide, size = self.wdef.slide, self.wdef.size
        lateness = self.allowed_lateness
        op = self.op
        # align the first candidate window end to the slide grid
        w = -(-self.next_win_end // slide) * slide
        last_w = (up_to // slide) * slide
        # clamp to the last window any present frame participates in (an
        # idle source advertises a MAX_TIME watermark; without the clamp the
        # emission loop would walk to infinity)
        top = max((ks.max_frame for ks in self.key_state.values()),
                  default=None)
        if top is None:
            return
        last_w = min(last_w, top + size - slide)
        while w <= last_w:
            for key in list(self.key_state):
                ks = self.key_state[key]
                if ks.last_emitted >= w:
                    continue
                acc = self._window_value(key, ks, w)
                if acc is not None:
                    self._emit_buf.append(
                        Event(w - 1, key, WindowResult(w, key, op.export(acc))))
                ks.last_emitted = w
                if (not lateness and ks.max_frame <= w - size + slide
                        and (ks.ring is None or not ks.ring)):
                    # with lateness the key state must outlive the window:
                    # ``last_emitted`` decides whether a late frame re-fires
                    # or opens fresh windows (GC'd in the sweep below)
                    del self.key_state[key]
            if not self.use_deduct:
                # frames feed re-fires until every window covering them is
                # past the lateness horizon
                evict_to = w - size + slide - lateness
                for fkey in [fk for fk in self.frames if fk[1] <= evict_to]:
                    del self.frames[fkey]
            w += slide
            self.next_win_end = w
        if lateness:
            # GC keys whose frames are all evicted AND whose emission front
            # is old enough that any still-admissible frame (fts > wm -
            # lateness > last_emitted) would only open fresh windows
            evict_to = last_w - size + slide - lateness
            stale = [key for key, ks in self.key_state.items()
                     if ks.max_frame <= evict_to
                     and ks.last_emitted + lateness <= up_to]
            for key in stale:
                del self.key_state[key]

    def try_process_watermark(self, wm: Watermark) -> bool:
        # flush leftovers first, then close for THIS watermark (idempotent:
        # per-key last_emitted guards + next_win_end make a re-entry after
        # partial flush a no-op) — returning True without the close would
        # forward the watermark ahead of the windows it closes
        if not self._flush():
            return False
        self._emit_windows_up_to(wm.ts)
        return self._flush()

    def complete(self) -> bool:
        # no emptiness guard: emission is idempotent (per-key last_emitted,
        # refires clear as they queue), and gating it on a drained buffer
        # would drop the final windows when LateEvents sit buffered at DONE
        top = max((ks.max_frame for ks in self.key_state.values()),
                  default=None)
        if top is not None:
            self._emit_windows_up_to(top + self.wdef.size - self.wdef.slide)
        else:
            self._emit_refires()
        return self._flush()

    def _flush(self) -> bool:
        buf = self._emit_buf
        while buf:
            if not self.outbox.offer(buf[0]):
                return False
            buf.popleft()
        return True

    # -- snapshots ------------------------------------------------------------
    def save_to_snapshot(self) -> bool:
        # backpressured window results must precede the barrier: the frames
        # that produced them are already evicted, so a restore that loses
        # the buffer can never regenerate them
        if not self._flush():
            return False
        for (key, fts), acc in self.frames.items():
            self.outbox.offer_to_snapshot(("f", key, fts), acc)
        for key, ks in self.key_state.items():
            # the ring must be copied: the processor keeps accumulating
            # into the live dict between this barrier and the job-wide
            # commit, and an aliased payload would smuggle post-barrier
            # events into the snapshot
            ring = None if ks.ring is None else dict(ks.ring)
            self.outbox.offer_to_snapshot(
                ("k", key), (ks.max_frame, ks.last_emitted, ring))
        for key, w in self._refire:
            self.outbox.offer_to_snapshot(("r", key, w), True)
        return True

    def restore_from_snapshot(self, items) -> None:
        combine = self.op.combine
        for skey, val in items:
            tag = skey[0]
            if tag == "r":
                self._refire.add((skey[1], skey[2]))
            elif tag == "f":
                _, key, fts = skey
                cur = self.frames.get((key, fts))
                self.frames[(key, fts)] = (val if cur is None
                                           else combine(cur, val))
                if self.next_win_end is None or fts < self.next_win_end:
                    self.next_win_end = fts
            else:
                _, key = skey
                max_frame, last_emitted, ring = val
                ks = self.key_state.get(key)
                if ks is None:
                    ks = self.key_state[key] = _KeyState()
                ks.max_frame = max(ks.max_frame, max_frame)
                ks.last_emitted = max(ks.last_emitted, last_emitted)
                if ring:
                    if ks.ring is None:
                        ks.ring = {}
                    for fts, acc in ring.items():
                        ks.ring[fts] = (combine(ks.ring[fts], acc)
                                        if fts in ks.ring else acc)
                        ks.running = (acc if ks.running is None
                                      else combine(ks.running, acc))
                    nxt = min(ring) + self.wdef.slide
                    if self.next_win_end is None or nxt < self.next_win_end:
                        self.next_win_end = min(self.next_win_end or nxt, nxt)

    def finish_snapshot_restore(self) -> None:
        # Emission restarts from the earliest restored frame's window; the
        # per-key ``last_emitted`` guards make re-considered windows no-ops,
        # so no global fast-forward is needed (and fast-forwarding could skip
        # windows of keys that were behind at snapshot time).
        pass

    def snapshot_partition(self, skey):
        # ("f", key, fts), ("k", key), ("r", key, w): partition by event key
        from .dag import PARTITION_COUNT
        return hash(skey[1]) % PARTITION_COUNT


# ---------------------------------------------------------------------------
# Session windows: gap-based, key-local merge, single stage
# ---------------------------------------------------------------------------


class SessionResult(WindowResult):
    """Window result of a session: additionally carries the session start."""

    __slots__ = ("window_start",)

    def __init__(self, window_start: int, window_end: int, key, value):
        super().__init__(window_end, key, value)
        self.window_start = window_start

    def __repr__(self):  # pragma: no cover
        return (f"SessionResult([{self.window_start}, {self.window_end}), "
                f"key={self.key!r}, value={self.value!r})")


class _Session:
    """One session interval [start, end) with its accumulator.

    ``end`` is the session close time: last event ts + gap.  ``emitted``
    marks a closed session whose result went out; a late admissible event
    merging into it clears the flag so the updated result re-fires.
    """

    __slots__ = ("start", "end", "acc", "emitted")

    def __init__(self, start: int, end: int, acc, emitted: bool = False):
        self.start = start
        self.end = end
        self.acc = acc
        self.emitted = emitted


class SessionWindowProcessor(Processor):
    """Gap-based session windows (NEXMark Q11's "bids per user session").

    Unlike the two-stage sliding plan, sessions run as ONE keyed vertex on a
    distributed partitioned edge: merging is key-local and a session's frame
    boundaries are data-dependent, so there is no fixed frame grid to split
    the aggregation over (Jet makes the same choice).

    Semantics:

    * an event opens the interval ``[ts, ts + gap)``; intervals of one key
      that touch are merged (accumulators combined via ``op.combine``);
    * a session closes when the watermark reaches its end, emitting
      ``Event(end - 1, key, SessionResult(start, end, key, export(acc)))``;
    * closed sessions are retained for ``allowed_lateness``: an admissible
      late event (``ts >= wm - allowed_lateness``) merges in and re-fires
      the updated result; anything later is counted in ``late_dropped`` and
      optionally forwarded as a :class:`LateEvent` (late side output);
    * state snapshots per key through the standard
      ``save_to_snapshot``/``restore_from_snapshot`` protocol, so sessions
      survive restarts and topology changes exactly-once.
    """

    #: same contract as AccumulateByFrameProcessor: the lateness horizon
    #: (_last_wm) rebuilds from the replayed stream's own watermarks, the
    #: emit buffer is flushed before every barrier, late_dropped is
    #: telemetry
    EPHEMERAL_STATE = frozenset({"_last_wm", "_emit_buf", "late_dropped"})

    def __init__(self, sdef: SessionWindowDef, op: AggregateOperation,
                 allowed_lateness: int = 0, late_output: bool = False):
        self.gap = sdef.gap
        self.op = op
        self.allowed_lateness = allowed_lateness
        self.late_output = late_output
        self.late_dropped = 0
        # key -> list of _Session sorted by start
        self.sessions: Dict[Any, List[_Session]] = {}
        self._emit_buf: deque = deque()
        self._last_wm = MIN_TIME

    # -- ingest ----------------------------------------------------------------
    def _merge_interval(self, sess: List[_Session], lo: int,
                        hi: int) -> Optional[_Session]:
        """Collapse every session strictly overlapping ``[lo, hi)`` into one
        (extended to cover [lo, hi)) and return it; None if none overlap.
        Strict overlap: events separated by exactly ``gap`` start a NEW
        session.  Per-key session counts are small (gap >> intra-burst
        spacing), a scan is fine.  The caller folds its own contribution
        into ``.acc``/``.emitted``."""
        touching = [s for s in sess if s.start < hi and lo < s.end]
        if not touching:
            return None
        merged = touching[0]
        for other in touching[1:]:
            merged.end = max(merged.end, other.end)
            merged.start = min(merged.start, other.start)
            merged.acc = self.op.combine(merged.acc, other.acc)
            merged.emitted = merged.emitted and other.emitted
            sess.remove(other)
        merged.start = min(merged.start, lo)
        merged.end = max(merged.end, hi)
        return merged

    def _merge_event(self, key, ts: int, ev: Event, acc_fn) -> None:
        lo, hi = ts, ts + self.gap
        sess = self.sessions.get(key)
        if sess is None:
            sess = self.sessions[key] = []
        merged = self._merge_interval(sess, lo, hi)
        if merged is None:
            sess.append(_Session(lo, hi, acc_fn(self.op.create(), ev)))
            sess.sort(key=lambda x: x.start)
            return
        merged.acc = acc_fn(merged.acc, ev)
        # any content change invalidates a previously emitted result
        merged.emitted = False

    def process(self, ordinal: int, inbox: Inbox) -> None:
        op = self.op
        acc_fn = op.accumulate_fns[min(ordinal, len(op.accumulate_fns) - 1)]
        horizon = self._last_wm - self.allowed_lateness
        for ev in inbox:
            ts = ev.ts
            if ts < horizon:
                self.late_dropped += 1
                if self.late_output:
                    le = LateEvent(ts, ev.key, ev.value)
                    if not self.outbox.offer(le):
                        self._emit_buf.append(le)
                continue
            self._merge_event(ev.key, ts, ev, acc_fn)
        inbox.clear()

    # -- emission ---------------------------------------------------------------
    def _close_up_to(self, wm_ts: int, retain: bool) -> None:
        """Emit every closed not-yet-emitted session; drop retained closed
        sessions whose lateness horizon passed (``retain=False`` drops at
        emission — batch completion)."""
        op = self.op
        ready: List[Tuple[int, Any, _Session]] = []
        for key, sess in self.sessions.items():
            for s in sess:
                if s.end <= wm_ts and not s.emitted:
                    ready.append((s.end, key, s))
        ready.sort(key=lambda x: (x[0], x[2].start))
        for end, key, s in ready:
            self._emit_buf.append(
                Event(end - 1, key,
                      SessionResult(s.start, end, key, op.export(s.acc))))
            s.emitted = True
        drop_before = (wm_ts - self.allowed_lateness if retain
                       else MAX_TIME)
        for key in list(self.sessions):
            kept = [s for s in self.sessions[key]
                    if not (s.emitted and s.end <= drop_before)]
            if kept:
                self.sessions[key] = kept
            else:
                del self.sessions[key]

    def try_process_watermark(self, wm: Watermark) -> bool:
        # leftovers (backpressured LateEvents) first — then the close work
        # must still run for THIS watermark, or it would be forwarded ahead
        # of the session results it closes
        if not self._flush():
            return False
        if wm.ts > self._last_wm:       # close exactly once per watermark
            self._last_wm = wm.ts
            self._close_up_to(wm.ts, retain=True)
        return self._flush()

    def complete(self) -> bool:
        # unconditional: closing is idempotent (sessions emit once and are
        # dropped), and gating on a drained buffer would lose every open
        # session when LateEvents sit buffered at DONE
        self._close_up_to(MAX_TIME, retain=False)
        return self._flush()

    def _flush(self) -> bool:
        buf = self._emit_buf
        while buf:
            if not self.outbox.offer(buf[0]):
                return False
            buf.popleft()
        return True

    # -- snapshots ------------------------------------------------------------
    def save_to_snapshot(self) -> bool:
        # backpressured LateEvents are pre-barrier output: emit them before
        # the barrier or a restore loses them
        if not self._flush():
            return False
        for key, sess in self.sessions.items():
            self.outbox.offer_to_snapshot(
                ("s", key),
                [(s.start, s.end, s.acc, s.emitted) for s in sess])
        # _last_wm deliberately not snapshotted — same rationale as
        # AccumulateByFrameProcessor: the horizon rebuilds from replayed
        # watermarks; restoring it would drop replayed events
        return True

    def restore_from_snapshot(self, items) -> None:
        combine = self.op.combine
        for (tag, key), vals in items:
            if tag != "s":
                continue
            sess = self.sessions.get(key)
            if sess is None:
                self.sessions[key] = [
                    _Session(st, en, acc, em) for st, en, acc, em in vals]
                continue
            # merge the restored intervals with whatever is already there
            # (two snapshot shards of one key land on the same instance)
            for st, en, acc, em in vals:
                merged = self._merge_interval(sess, st, en)
                if merged is None:
                    sess.append(_Session(st, en, acc, em))
                    continue
                merged.acc = combine(merged.acc, acc)
                merged.emitted = merged.emitted and em
            sess.sort(key=lambda x: x.start)

    def snapshot_partition(self, skey):
        from .dag import PARTITION_COUNT
        return hash(skey[1]) % PARTITION_COUNT
