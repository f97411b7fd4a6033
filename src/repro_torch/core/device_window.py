"""The host→device bridge: a window-aggregation vertex offloaded to the
device tier, in PyTorch.

The port of ``repro/core/device_window.py``; the contract below is the
reference's, and the differences in mechanism follow it.

``Pipeline.window(w).aggregate(op, placement="device")`` lowers to a
:class:`DeviceWindowProcessor` vertex on a distributed partitioned
in-edge — each parallel instance owns a StreamExecutor over its
key-partition subset (partitioning of device state follows partitioning
of compute) — replacing the host two-stage accumulate/combine plan with
the device tier's fused accumulate+emit step
(:mod:`repro_torch.streaming`):

* **Packing** — incoming :class:`~repro.core.events.EventBlock` columns
  (the host hot path) append into fixed-size staging arrays; scalar
  :class:`~repro.core.events.Event`\\ s take the same arrays one row at a
  time.  A full staging buffer becomes one padded device batch
  ``{ts, key, value, valid, wm}``: the tail rows carry ``valid=False``
  and keys hash-bucket into ``n_key_buckets`` via ``key % n_key_buckets``
  (injective whenever the key space fits the bucket count; wider key
  spaces aggregate per *bucket* — the documented caveat).  The original
  key of every bucket is remembered host-side so emissions convert back.
* **Async drive** — batch *i+1* stages (``stage_batch``) while step *i*
  executes; step outputs stay on device in an ordered pending list, each
  with a ``torch.cuda.Event`` recorded after its step, and are only
  materialized once that event has completed (polled from ``poll_async``
  / the watermark path), so the harvest NEVER blocks on the device.
* **Watermarks** — the device runs in hint-only frontier mode
  (``frontier_from_data=False``): host watermarks (already lagged at the
  source) are the only event-time authority, so every device instance
  observes the identical watermark sequence.  A watermark that does not
  cross a slide boundary forwards immediately (no window can close); one
  that does submits a wm-hinted step and forwards only after that step's
  emissions are harvested and the device emission front has passed the
  watermark — downstream still sees every result *before* the watermark
  that closed it, exactly the host contract.
* **Unpacking** — harvested ``(window_ends, results)`` rows become
  ``Event(w_end - 1, key, WindowResult(w_end, key, value))`` per nonzero
  bucket, the exact shape the host two-stage combiner emits (near-integer
  values collapse to int: counting/integer-sum aggregates compare equal
  to the host path bit-for-bit up to f32's 2**24 integer range).
* **Snapshots** — barriers align to step boundaries: staged rows flush as
  a final step, emission catches up to the last processed watermark
  (identical across instances — the coalesced watermark sequence is), and
  the device state stores per ORIGINAL key as ``("k", key) -> [(frame,
  value), ...]`` entries partitioned like the data keys, so restore after
  a topology change merges shards additively under the standard per-key
  contract.

Where the port differs from the reference in mechanism (not in result):

* **Where it runs.** On ``cuda`` unless the caller names a device
  (``device="cpu"`` runs the plain versions of the kernels, as the tests
  do); with no card and no device named the constructor raises.  The
  CUDA context is created when the first processor is built, never at
  import time.
* **Readiness.** Tensors have no ``is_ready()``: each step records a
  ``torch.cuda.Event`` on the current stream, stored with its pending
  output; ``_is_ready`` queries it, a blocking harvest synchronises it.
  On the CPU a step is complete when it returns (no event).
* **What the tasklet still waits for.** The port's ``emit`` reads the
  device once a step on a card (the emit kernel's status: rows and
  rounds; ``streaming/window.py``), so ``_submit`` waits for that read
  inside ``executor.step``; only the harvest is free of device waits.
* **Conversion reads only the valid rows.** A step's valid rows are
  exactly the prefix ``[0, out["rows"])`` of its output buffer, and only
  that prefix of ``window_ends`` and ``results`` is copied to the host
  (the reference reads the whole ``(EB, K)`` buffer: 66 MB a step at the
  paper's configuration).
* **State is updated in place** by the step, so the snapshot goes
  through ``executor.snapshot`` (a clone) and a restore builds fresh
  tensors on the executor's device.
* **The emission frontier reaches every restoring instance.**  The
  reference saves an instance's watermark, emission cursor and top
  timestamp only in its ``("meta", idx)`` entry, which lands on one
  partition (a hash of the key, random across processes), so an instance
  of the restoring job may receive none: it restarts its emission from
  ``-1`` and re-fires windows whose first frames were already evicted,
  with partial counts.  The port also saves that frontier under every
  partition as ``("frontier", p)`` entries (the idiom of the sources'
  replicated offsets) and restores each instance to the largest it
  receives; the ``("meta", idx)`` entry still carries the drop counters,
  which sum over the instances that receive one.  With no partition
  count in the context (a standalone harness) nothing is replicated and
  the entries are the reference's.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from ..devices import resolve_device
from .events import Event, EventBlock, Watermark
from .processor import Inbox, Processor
from .window import AggregateOperation, SlidingWindowDef, WindowResult

def _as_int_if_integral(v: float):
    r = round(v)
    return int(r) if abs(v - r) < 1e-6 else float(v)


class DeviceWindowProcessor(Processor):
    """Block-aware tasklet processor driving a device StreamExecutor.

    ``op`` must be a vectorizable aggregate: ``counting()`` or a
    ``summing(...)`` whose getter carries a block form (the same ops the
    host columnar fast path accepts).  Blocks feed the packer whole; with
    a summing op lacking a block getter the vertex falls back to scalar
    ingestion (``accepts_blocks`` stays False and the tasklet shim
    explodes blocks at the queue boundary).

    Known divergence from the host plan: the device pane matrix cannot
    distinguish "no events" from "events summing to exactly 0", so a
    summing window whose total is 0 emits nothing here while the host
    combiner emits an explicit ``WindowResult(..., 0)``.  Counting and
    positive-valued sums (the NEXMark shapes) are unaffected; keep
    sign-cancelling sums on the host if the empty-vs-zero distinction
    matters downstream.
    """

    #: Host-side staging and flow state never survives a restart by
    #: design: save_to_snapshot submits staged rows as a final pre-barrier
    #: device step and drains every in-flight output, so the durable
    #: window content lives entirely in the device state (saved as
    #: ("k", key) shards + ("meta", idx) entries and rebuilt by
    #: finish_snapshot_restore).  _emit_buf flushes before the barrier,
    #: watermark cursors re-advance from replayed sources, executor/_spec
    #: are rebuilt lazily by _ensure_executor, and _bucket_collisions is
    #: telemetry.  _last_event (the CUDA event of the newest step) goes
    #: with the device work it marks, which a barrier drains.
    EPHEMERAL_STATE = frozenset({
        "_ts", "_key", "_val", "_n", "_pending", "_emit_buf", "_steps",
        "_progress_hint", "_last_wm", "_wm_submitted", "_closed",
        "_spec", "_bucket_collisions", "_last_event",
    })

    def __init__(self, wdef: SlidingWindowDef, op: AggregateOperation,
                 n_key_buckets: int = 1024, batch_size: int = 1024,
                 max_windows_per_step: int = 8, ring_margin: int = 8,
                 emit_rounds: int = 0, device=None):
        if op.kind not in ("count", "sum"):
            raise ValueError(
                "device placement supports counting()/summing() aggregates "
                f"(got kind={op.kind!r}); keep other ops on the host")
        self.device = resolve_device(device, "DeviceWindowProcessor")
        self.wdef = wdef
        self.op = op
        self.n_key_buckets = n_key_buckets
        self.batch_size = batch_size
        self.max_windows_per_step = max_windows_per_step
        self.ring_margin = ring_margin
        self.emit_rounds = emit_rounds
        # blocks are only useful when the value column vectorizes
        self.accepts_blocks = (op.kind == "count"
                               or op.block_get is not None)

        self.executor = None
        self.state = None
        # staging buffers (one device batch)
        B = batch_size
        self._ts = np.zeros(B, np.int32)
        self._key = np.zeros(B, np.int32)
        self._val = np.zeros(B, np.float32)
        self._n = 0
        #: bucket -> original key (the inverse of the packing hash; first
        #: writer wins on collision — see the module docstring caveat).
        #: An int64 array so block ingestion updates it vectorized.
        self._bkey_sentinel = np.int64(np.iinfo(np.int64).min)
        self._bucket_key = np.full(n_key_buckets, self._bkey_sentinel,
                                   np.int64)
        self._bucket_collisions = 0
        self._closed = False
        #: ordered in-flight step outputs: (wm_hint_or_None, device out,
        #: the step's CUDA event or None on the CPU)
        self._pending: deque = deque()
        self._last_event: Optional[torch.cuda.Event] = None
        self._emit_buf: deque = deque()
        self._wm_submitted = -1          # highest hint staged to the device
        self._last_wm = -1               # highest watermark fully processed
        self._top_ts = -1                # max event ts seen (host-side)
        self._steps = 0                  # telemetry: device steps driven
        self._progress_hint = False      # last _harvest_ready made progress
        self._snap_entries: Optional[List[Tuple[Any, Any]]] = None
        self._restore_frames: Dict[Any, Dict[int, float]] = {}
        self._restore_meta: List[Dict] = []
        self._restore_frontier: List[Dict] = []

    # ------------------------------------------------------------ set-up --
    def init(self, outbox, ctx) -> None:
        super().init(outbox, ctx)
        # build + warm the executor NOW (one all-invalid step builds and
        # loads the CUDA library and makes the first launch) so the
        # one-time cost lands at job start, not in the middle of a paced
        # run's latency measurement
        self._ensure_executor()
        staged, cnt = self.executor.stage_batch({
            "ts": np.zeros(self.batch_size, np.int32),
            "key": np.zeros(self.batch_size, np.int32),
            "value": np.zeros(self.batch_size, np.float32),
            "valid": np.zeros(self.batch_size, bool),
            "wm": np.asarray(-1, np.int32)})
        self.state, out = self.executor.step(self.state, staged,
                                             valid_count=cnt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # the launch finished

    def _ensure_executor(self) -> None:
        if self.executor is not None:
            return
        from ..streaming import (StreamExecutor, StreamJobConfig,
                                 VectorWindowSpec)
        spec = VectorWindowSpec(
            size_ms=self.wdef.size, slide_ms=self.wdef.slide,
            n_key_buckets=self.n_key_buckets,
            max_windows_per_step=self.max_windows_per_step,
            ring_margin=self.ring_margin, emit_rounds=self.emit_rounds,
            frontier_from_data=False)
        self.executor = StreamExecutor(
            StreamJobConfig(window=spec, batch_size=self.batch_size),
            device=self.device)
        self.state = self.executor.init_state()
        self._spec = spec

    # ------------------------------------------------------------ ingest --
    def process(self, ordinal: int, inbox: Inbox) -> None:
        self._ensure_executor()
        op = self.op
        for item in inbox:
            if item.__class__ is EventBlock:
                self._ingest_block(item)
            else:
                # scalar fallback: one staged row per event; the op's own
                # accumulate over a fresh accumulator IS the row weight
                # (count -> 1, sum -> get(ev))
                b = int(item.key) % self.n_key_buckets
                prev = self._bucket_key[b]
                if prev == self._bkey_sentinel:
                    self._bucket_key[b] = item.key
                elif prev != item.key:
                    self._bucket_collisions += 1
                n = self._n
                self._ts[n] = item.ts
                self._key[n] = b
                self._val[n] = op.accumulate(op.create(), item)
                if item.ts > self._top_ts:
                    self._top_ts = item.ts
                self._n = n + 1
                if self._n == self.batch_size:
                    self._submit()
        inbox.clear()
        # opportunistically drain finished device steps (non-blocking)
        self._harvest_ready()
        if self._emit_buf:
            self._flush_emit()

    def _ingest_block(self, blk: EventBlock) -> None:
        K, B = self.n_key_buckets, self.batch_size
        ts = blk.ts
        buckets = blk.key % K
        if self.op.kind == "count":
            weights = None
        else:
            weights = np.asarray(self.op.block_get(blk), np.float32)
        # remember the original key per bucket (vectorized; first writer
        # wins) and count collisions — buckets already bound to a
        # DIFFERENT key — for telemetry
        bk = np.asarray(buckets, np.int64)
        kk = np.asarray(blk.key, np.int64)
        bmap = self._bucket_key
        prev = bmap[bk]
        fresh = prev == self._bkey_sentinel
        if fresh.any():
            # first occurrence in this block wins among duplicates: write
            # in reverse row order so the earliest assignment lands last
            idx = np.nonzero(fresh)[0][::-1]
            bmap[bk[idx]] = kk[idx]
            prev = bmap[bk]
        self._bucket_collisions += int(np.count_nonzero(prev != kk))
        top = int(ts.max()) if len(ts) else -1
        if top > np.iinfo(np.int32).max:
            # the device tier computes event time in int32 ms; silently
            # wrapping an int64 host timestamp would corrupt every frame
            # assignment downstream (the scalar path raises naturally)
            raise ValueError(
                f"device window timestamps must fit int32 ms (got {top}); "
                "rebase the stream to a relative time origin")
        if top > self._top_ts:
            self._top_ts = top
        i, n = 0, len(ts)
        while i < n:
            take = min(B - self._n, n - i)
            sl = slice(i, i + take)
            dst = slice(self._n, self._n + take)
            self._ts[dst] = ts[sl]
            self._key[dst] = buckets[sl]
            self._val[dst] = 1.0 if weights is None else weights[sl]
            self._n += take
            i += take
            if self._n == B:
                self._submit()

    # ------------------------------------------------------- device drive --
    def _submit(self, wm_hint: Optional[int] = None) -> None:
        """Stage the current staging buffer as one padded device batch and
        dispatch the step asynchronously; the output joins the pending
        list as a device future."""
        n = self._n
        B = self.batch_size
        wm = np.asarray(-1 if wm_hint is None else wm_hint, np.int32)
        if n == B:
            batch = {"ts": self._ts.copy(), "key": self._key.copy(),
                     "value": self._val.copy(),
                     "valid": np.ones(B, bool), "wm": wm}
        else:
            # pad the partial burst to the fixed device batch size
            # (np.pad copies, so the staging buffers stay reusable)
            pad = (0, B - n)
            batch = {"ts": np.pad(self._ts[:n], pad),
                     "key": np.pad(self._key[:n], pad),
                     "value": np.pad(self._val[:n], pad),
                     "valid": np.pad(np.ones(n, bool), pad), "wm": wm}
        staged, cnt = self.executor.stage_batch(batch)
        self.state, out = self.executor.step(self.state, staged,
                                             valid_count=cnt)
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        self._last_event = ev
        self._pending.append((wm_hint, out, ev))
        self._steps += 1
        self._n = 0

    @staticmethod
    def _is_ready(ev: Optional[torch.cuda.Event]) -> bool:
        return ev is None or ev.query()

    def _harvest_ready(self, block: bool = False) -> bool:
        """Materialize finished pending outputs in order, converting their
        emissions into WindowResult events.  Stops at the first output
        still executing unless ``block``; returns True when the pending
        list fully drained."""
        pending = self._pending
        progress = False
        while pending:
            _hint, out, ev = pending[0]
            if not self._is_ready(ev):
                if not block:
                    break
                ev.synchronize()
            self._convert(out)
            pending.popleft()
            progress = True
        self._progress_hint = progress
        return not pending

    def _convert(self, out: Dict) -> None:
        # the valid rows are exactly the prefix [0, rows): copy only it
        rows = out["rows"]
        if not rows:
            return
        ends = out["window_ends"][:rows].cpu().numpy()
        res = out["results"][:rows].cpu().numpy()
        bmap, sentinel = self._bucket_key, self._bkey_sentinel
        buf = self._emit_buf
        for i in range(rows):
            row = res[i]
            w_end = int(ends[i])
            for b in np.nonzero(row)[0].tolist():
                k = bmap[b]
                key = b if k == sentinel else int(k)
                val = _as_int_if_integral(float(row[b]))
                buf.append(
                    Event(w_end - 1, key, WindowResult(w_end, key, val)))

    def _flush_emit(self) -> bool:
        buf = self._emit_buf
        while buf:
            if not self.outbox.offer(buf[0]):
                return False
            buf.popleft()
        return True

    def poll_async(self) -> bool:
        """Non-blocking pump the tasklet calls every slice: harvest device
        futures that finished since, and move their emissions out."""
        if self.executor is None or not self._pending:
            return False
        self._harvest_ready()
        progress = self._progress_hint
        if self._emit_buf:
            progress |= self._flush_emit()
        return progress

    # --------------------------------------------------------- watermarks --
    def try_process_watermark(self, wm: Watermark) -> bool:
        """Forward the watermark only once every window it closes has been
        emitted downstream (the host ordering contract), without ever
        blocking: not-ready device futures just defer to the next call."""
        self._ensure_executor()
        if not self._flush_emit():
            return False
        slide = self.wdef.slide
        if wm.ts // slide == self._last_wm // slide and wm.ts >= 0 \
                and self._last_wm >= 0:
            # no slide boundary crossed: window closure is slide-granular,
            # so this watermark cannot close anything the previous one did
            # not — forward immediately without a device roundtrip.  The
            # hint itself is NOT sent to the device; that is safe because
            # a later boundary-crossing watermark (or complete()'s
            # close-out) supersedes it before any emission decision needs
            # it.
            self._last_wm = wm.ts
            return True
        if wm.ts > self._wm_submitted:
            # flush staged rows + the hint in ONE wm-carrying step
            self._submit(wm_hint=wm.ts)
            self._wm_submitted = wm.ts
        # harvest everything up to (and including) the hint step
        if not self._harvest_ready():
            return False
        # the device emission front must have passed the watermark — a
        # bounded emit loop may need another round after a very large jump
        if not self._is_ready(self._last_event):
            return False
        ne_v = int(self.state["next_emit"])
        if 0 <= ne_v <= wm.ts:
            self._submit(wm_hint=wm.ts)     # another catch-up round
            return False
        if not self._flush_emit():
            return False
        self._last_wm = wm.ts
        return True

    # ----------------------------------------------------------- complete --
    def complete(self) -> bool:
        if self.executor is None:
            return True
        # close every open window: flush staged rows, then drive wm-hinted
        # steps until no live frame remains (end-of-stream may sync)
        if not self._closed:
            if self._n:
                self._submit()
            close_wm = max(self._top_ts + self.wdef.size + self.wdef.slide,
                           self._last_wm + self.wdef.slide)
            for _ in range(10_000):
                self._submit(wm_hint=close_wm)
                self._harvest_ready(block=True)
                if not bool((self.state["slot_frame"] >= 0).any()):
                    break
            self._harvest_ready(block=True)
            self._closed = True
        return self._flush_emit()

    # ----------------------------------------------------------- snapshot --
    def save_to_snapshot(self) -> bool:
        if self.executor is None:
            return True
        if self._snap_entries is None:
            # step-boundary alignment: staged rows become a final
            # pre-barrier step, emission catches up to the last processed
            # watermark (identical across instances), in-flight outputs
            # drain.  Snapshot time may sync with the device.
            if self._n:
                self._submit(wm_hint=self._wm_submitted
                             if self._wm_submitted >= 0 else None)
            for _ in range(10_000):
                self._harvest_ready(block=True)
                ne_v = int(self.state["next_emit"])
                if not (0 <= ne_v <= self._last_wm):
                    break
                self._submit(wm_hint=self._last_wm)
            self._snap_entries = self._build_snapshot_entries()
        # pre-barrier output (results the catch-up produced) leaves first
        if not self._flush_emit():
            return False
        for skey, val in self._snap_entries:
            self.outbox.offer_to_snapshot(skey, val)
        self._snap_entries = None
        return True

    def _build_snapshot_entries(self) -> List[Tuple[Any, Any]]:
        # a clone: the live state changes in place under later steps
        snap = self.executor.snapshot(self.state)
        host = {k: v.cpu().numpy() for k, v in snap.items()}
        panes, slot_frame = host["panes"], host["slot_frame"]
        entries: List[Tuple[Any, Any]] = []
        # per ORIGINAL key: [(frame, partial)] — mergeable shards under
        # the standard restore contract, partitioned like the data keys
        per_key: Dict[Any, List[Tuple[int, float]]] = {}
        bmap, sentinel = self._bucket_key, self._bkey_sentinel
        slots, buckets = np.nonzero(panes)
        for s, b in zip(slots.tolist(), buckets.tolist()):
            f = int(slot_frame[s])
            if f < 0:
                continue
            k = bmap[b]
            key = b if k == sentinel else int(k)
            per_key.setdefault(key, []).append((f, float(panes[s, b])))
        for key, frames in per_key.items():
            entries.append((("k", key), frames))
        frontier = {"watermark": int(host["watermark"]),
                    "next_emit": int(host["next_emit"]),
                    "top_ts": self._top_ts}
        entries.append((("meta", self.ctx.global_index), dict(
            frontier, dropped_late=int(host["dropped_late"]),
            dropped_conflict=int(host["dropped_conflict"]))))
        # the frontier again under every partition, so every instance of
        # the restoring topology receives it (module docstring)
        n = self.ctx.partition_count
        for p in (range(n) if n else ()):
            entries.append((("frontier", p), frontier))
        return entries

    def snapshot_partition(self, skey):
        from .dag import PARTITION_COUNT
        if skey[0] == "k":
            return hash(skey[1]) % PARTITION_COUNT
        if skey[0] == "frontier":
            return skey[1]
        return None

    def restore_from_snapshot(self, items) -> None:
        for skey, val in items:
            if skey[0] == "k":
                frames = self._restore_frames.setdefault(skey[1], {})
                for f, v in val:
                    frames[f] = frames.get(f, 0.0) + v
            elif skey[0] == "meta":
                self._restore_meta.append(val)
            elif skey[0] == "frontier":
                self._restore_frontier.append(val)

    def finish_snapshot_restore(self) -> None:
        if not (self._restore_frames or self._restore_meta
                or self._restore_frontier):
            return
        self._ensure_executor()
        spec = self._spec
        R, K = spec.ring_len, spec.n_key_buckets
        panes = np.zeros((R, K), np.float32)
        slot_frame = np.full(R, -1, np.int32)
        dropped_conflict = 0
        # older frames win slot conflicts (they emit sooner); a shard pair
        # whose in-flight data diverged by more than the ring span loses
        # the younger frame into dropped_conflict, mirroring accumulate
        for key, frames in sorted(self._restore_frames.items(),
                                  key=lambda kv: str(kv[0])):
            b = int(key) % K
            if self._bucket_key[b] == self._bkey_sentinel:
                self._bucket_key[b] = key
            for f, v in sorted(frames.items()):
                s = f % R
                if slot_frame[s] < 0 or slot_frame[s] == f:
                    slot_frame[s] = f
                    panes[s, b] += v
                elif f < slot_frame[s]:
                    # evict the younger occupant's partials, keep the older
                    panes[s, :] = 0.0
                    slot_frame[s] = f
                    panes[s, b] = v
                    dropped_conflict += 1
                else:
                    dropped_conflict += 1
        meta = self._restore_meta
        front = meta + self._restore_frontier
        dev = self.executor.device

        def scalar(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        # window_state_init's layout: float32 panes, int32 slot_frame and
        # scalars (the executor never has a mesh here: no sharding)
        self.state = {
            "panes": torch.from_numpy(panes).to(dev),
            "slot_frame": torch.from_numpy(slot_frame).to(dev),
            "watermark": scalar(
                max((m["watermark"] for m in front), default=-1)),
            "next_emit": scalar(
                max((m["next_emit"] for m in front), default=-1)),
            "dropped_late": scalar(sum(m["dropped_late"] for m in meta)),
            "dropped_conflict": scalar(
                sum(m["dropped_conflict"] for m in meta)
                + dropped_conflict),
        }
        self._top_ts = max((m["top_ts"] for m in front), default=-1)
        self._restore_frames = {}
        self._restore_meta = []
        self._restore_frontier = []

    # ---------------------------------------------------------- telemetry --
    @property
    def late_dropped(self) -> int:
        """Deliberately dropped late events (device counter, host view)."""
        if self.state is None:
            return 0
        return int(self.state["dropped_late"])

    @property
    def conflict_dropped(self) -> int:
        if self.state is None:
            return 0
        return int(self.state["dropped_conflict"])

    @property
    def bucket_collisions(self) -> int:
        return self._bucket_collisions
