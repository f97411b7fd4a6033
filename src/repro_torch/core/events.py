"""Stream items flowing along Jet DAG edges.

Four kinds of items travel through queues, mirroring Hazelcast Jet:

* data events  — ``(timestamp, key, value)`` triples, represented by
  :class:`Event` (``__slots__`` for footprint; the scalar datapath
  allocates one object per event, nothing else),
* event blocks — :class:`EventBlock`, a struct-of-arrays record batch of
  many events travelling as ONE queue item (the columnar hot path),
* watermarks   — :class:`Watermark`, monotone event-time progress markers,
* barriers     — :class:`Barrier`, Chandy-Lamport snapshot markers,
* end-of-data  — :class:`DoneItem`, closes a batch edge.

Jet's wire format is binary; here the "wire" is an in-process queue so the
items themselves are the format.

The EventBlock contract
=======================

An :class:`EventBlock` is a batch of events in **stream order** stored as
NumPy columns — ``ts: int64[n]``, ``key: int64[n]``, ``value:
float64[n]`` — plus optional extras:

* ``payload`` — a per-row list of arbitrary Python values.  When present
  it IS the event value; the ``value`` column is then a scalar projection
  (or zeros) kept for vectorized aggregation.
* ``payload_fn(block, i)`` — a lazy row materializer.  Blocks whose
  values are cheap to *re-derive* (e.g. NEXMark model objects, a pure
  function of the stored ``seq`` column) carry this instead of a payload
  list, so the object-per-event cost is only ever paid on the explode
  fallback path, never on the columnar fast path.
* ``cols`` — named auxiliary int/float columns (e.g. ``kind``, ``seq``)
  that vectorized stage functions may read.  Auxiliary columns stay
  row-aligned through every slice/take/compress.

Semantics relative to the scalar path:

* A block is **observably equivalent** to its exploded event sequence:
  any processor that does not declare ``accepts_blocks = True`` receives
  the exploded :class:`Event` run instead (the tasklet's explode shim),
  so black-box processors keep exact per-event semantics.
* Blocks **never contain control items**.  Watermarks, barriers and DONE
  travel between blocks: a source splits its output at every watermark
  emission point, and barriers are only ever injected at block
  boundaries (the tasklet flushes pending data before snapshotting), so
  "blocks split at barrier boundaries" holds by construction.
* Blocks are **immutable once enqueued**.  In-place column mutation is
  allowed only while the producer still owns the block (source fusion),
  exactly like the scalar in-place chain rule.  A broadcast edge hands
  the SAME block object to every consumer.
* On a partitioned edge a block is routed by hashing the key column once
  and counting-sorting rows by destination queue; each destination
  receives one sub-block with its rows in stream order — the same
  per-queue sequence the per-event protocol produces.  Sub-block
  delivery is all-or-nothing per block (retried under backpressure), so
  no queue can observe a post-block item before the block's own rows.
* Float-valued aggregations may associate differently over a block than
  over single events (per-group partial sums combine once per block);
  integer aggregates (counting, integer sums) are bit-identical.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Callable, Dict, List, Optional

import numpy as np

MIN_TIME = -(2**62)
MAX_TIME = 2**62

# -- EventBlock wire format (shared-memory transport) ------------------------
#
#   [u32 n][u8 flags]
#   ts  : n * int64   (raw little-endian slab)
#   key : n * int64
#   value : n * float64            (flags bit 0)
#   aux cols (flags bit 1): [u8 ncols] then per column
#       [u8 namelen][name ascii][u8 dlen][dtype.str ascii][raw bytes]
#   extras (flags bit 2): [u32 plen][pickle((payload, payload_fn))]
#
# The three primary columns cross process boundaries as raw byte slabs —
# deserialization is one ``np.frombuffer(...).copy()`` per column, no
# per-row work.  Only ``payload``/``payload_fn`` (arbitrary Python) ride
# through pickle; a block whose ``payload_fn`` itself cannot pickle is
# materialized into a payload list instead, so the wire form is always
# observably equivalent to the original block.

_BLK_HAS_VALUE = 1
_BLK_HAS_COLS = 2
_BLK_HAS_EXTRAS = 4
_BLK_HDR = struct.Struct("<IB")
_U32 = struct.Struct("<I")


class Event:
    """A timestamped, keyed data record."""

    __slots__ = ("ts", "key", "value")

    def __init__(self, ts: int, key, value):
        self.ts = ts
        self.key = key
        self.value = value

    def with_value(self, value) -> "Event":
        return Event(self.ts, self.key, value)

    def with_key(self, key) -> "Event":
        return Event(self.ts, key, self.value)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Event(ts={self.ts}, key={self.key!r}, value={self.value!r})"


class LateEvent(Event):
    """A data event that arrived behind the watermark by more than the
    window's allowed lateness.

    Window processors emit the original (ts, key, value) wrapped in this
    type onto their out-edges; a ``late_sink`` attached via the Pipeline
    API receives exactly these, while the regular downstream ignores them.
    Being an :class:`Event` subclass it routes like any data item
    (partitioned edges read ``.key``)."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover
        return (f"LateEvent(ts={self.ts}, key={self.key!r}, "
                f"value={self.value!r})")


class EventBlock:
    """A struct-of-arrays batch of events travelling as one queue item.

    See the module docstring for the full contract.  Rows are in stream
    order; columns are NumPy arrays of one shared length.
    """

    __slots__ = ("ts", "key", "value", "payload", "payload_fn", "cols")

    def __init__(self, ts, key, value=None, payload: Optional[List] = None,
                 payload_fn: Optional[Callable] = None,
                 cols: Optional[Dict[str, Any]] = None):
        self.ts = ts
        self.key = key
        self.value = value
        self.payload = payload
        self.payload_fn = payload_fn
        self.cols = cols

    def __len__(self) -> int:
        return len(self.ts)

    # -- row value materialization (explode fallback path) -------------------
    def values(self) -> List:
        """Per-row Python values; materializes (and caches) ``payload_fn``."""
        if self.payload is None:
            if self.payload_fn is not None:
                fn = self.payload_fn
                self.payload = [fn(self, i) for i in range(len(self.ts))]
            else:
                v = self.value
                if v is None:
                    self.payload = [None] * len(self.ts)
                else:
                    self.payload = [x.item() for x in v]
        return self.payload

    def value_at(self, i: int):
        if self.payload is not None:
            return self.payload[i]
        if self.payload_fn is not None:
            return self.payload_fn(self, i)
        return None if self.value is None else self.value[i].item()

    def to_events(self) -> List["Event"]:
        """Explode into the equivalent per-event run (stream order).

        Timestamps and keys come out as plain Python ints so downstream
        scalar processors see exactly what a scalar producer would emit.
        """
        vals = self.values()
        return [Event(t, k, v) for t, k, v in
                zip(self.ts.tolist(), self.key.tolist(), vals)]

    # -- row selection (all preserve stream order among kept rows) -----------
    def _rebuild(self, sel) -> "EventBlock":
        payload = self.payload
        if payload is not None:
            payload = [payload[i] for i in sel.tolist()]
        cols = self.cols
        if cols is not None:
            cols = {name: c[sel] for name, c in cols.items()}
        return EventBlock(self.ts[sel], self.key[sel],
                          None if self.value is None else self.value[sel],
                          payload, None if payload is not None
                          else self.payload_fn, cols)

    def slice(self, lo: int, hi: int) -> "EventBlock":
        """Contiguous row range [lo, hi) (columns are views, not copies)."""
        sl = np.s_[lo:hi]
        payload = self.payload
        if payload is not None:
            payload = payload[lo:hi]
        cols = self.cols
        if cols is not None:
            cols = {name: c[sl] for name, c in cols.items()}
        return EventBlock(self.ts[sl], self.key[sl],
                          None if self.value is None else self.value[sl],
                          payload, None if payload is not None
                          else self.payload_fn, cols)

    def take(self, idx) -> "EventBlock":
        """Rows at ``idx`` (an integer index array), in that order."""
        return self._rebuild(np.asarray(idx))

    def compress(self, mask) -> "EventBlock":
        """Rows where the boolean ``mask`` holds (vectorized filter)."""
        return self._rebuild(np.nonzero(mask)[0])

    # -- column replacement (vectorized map / rekey) --------------------------
    def with_value_col(self, value) -> "EventBlock":
        """New value column; drops payload/payload_fn (the old objects no
        longer describe the mapped values)."""
        return EventBlock(self.ts, self.key,
                          np.asarray(value, dtype=np.float64),
                          None, None, self.cols)

    def with_key_col(self, key) -> "EventBlock":
        return EventBlock(self.ts, np.asarray(key, dtype=np.int64),
                          self.value, self.payload, self.payload_fn,
                          self.cols)

    # -- wire form (cross-process shared-memory rings) ------------------------
    def to_wire(self) -> bytes:
        """Serialize to the shm wire format (module docstring): the three
        primary columns as raw int64/float64 slabs, aux columns as tagged
        slabs, payload/payload_fn through pickle (with a materialize
        fallback when the row function itself cannot cross the wire)."""
        n = len(self.ts)
        flags = 0
        parts: List[bytes] = [b""]      # placeholder for the header
        parts.append(np.ascontiguousarray(self.ts, dtype="<i8").tobytes())
        parts.append(np.ascontiguousarray(self.key, dtype="<i8").tobytes())
        if self.value is not None:
            flags |= _BLK_HAS_VALUE
            parts.append(
                np.ascontiguousarray(self.value, dtype="<f8").tobytes())
        if self.cols:
            flags |= _BLK_HAS_COLS
            cparts = [bytes([len(self.cols)])]
            for name, col in self.cols.items():
                arr = np.ascontiguousarray(col)
                nb = name.encode("ascii")
                db = arr.dtype.str.encode("ascii")
                cparts.append(bytes([len(nb)]) + nb + bytes([len(db)]) + db
                              + arr.tobytes())
            parts.append(b"".join(cparts))
        extras = None
        if self.payload is not None or self.payload_fn is not None:
            try:
                extras = pickle.dumps((self.payload, self.payload_fn),
                                      protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:
                # unpicklable materializer: ship concrete row values
                extras = pickle.dumps((self.values(), None),
                                      protocol=pickle.HIGHEST_PROTOCOL)
        if extras is not None:
            flags |= _BLK_HAS_EXTRAS
            parts.append(_U32.pack(len(extras)))
            parts.append(extras)
        parts[0] = _BLK_HDR.pack(n, flags)
        return b"".join(parts)

    @classmethod
    def from_wire(cls, buf) -> "EventBlock":
        """Rebuild a block from :meth:`to_wire` bytes (or a memoryview over
        a shm ring segment).  Columns are copied out of the buffer — ring
        memory is recycled once the consumer advances."""
        buf = memoryview(buf)
        n, flags = _BLK_HDR.unpack_from(buf, 0)
        off = _BLK_HDR.size
        ts = np.frombuffer(buf, "<i8", n, off).copy()
        off += 8 * n
        key = np.frombuffer(buf, "<i8", n, off).copy()
        off += 8 * n
        value = None
        if flags & _BLK_HAS_VALUE:
            value = np.frombuffer(buf, "<f8", n, off).copy()
            off += 8 * n
        cols = None
        if flags & _BLK_HAS_COLS:
            ncols = buf[off]
            off += 1
            cols = {}
            for _ in range(ncols):
                nlen = buf[off]
                off += 1
                name = bytes(buf[off:off + nlen]).decode("ascii")
                off += nlen
                dlen = buf[off]
                off += 1
                dt = np.dtype(bytes(buf[off:off + dlen]).decode("ascii"))
                off += dlen
                cols[name] = np.frombuffer(buf, dt, n, off).copy()
                off += dt.itemsize * n
        payload = payload_fn = None
        if flags & _BLK_HAS_EXTRAS:
            (plen,) = _U32.unpack_from(buf, off)
            off += _U32.size
            payload, payload_fn = pickle.loads(buf[off:off + plen])
        return cls(ts, key, value, payload, payload_fn, cols)

    @classmethod
    def from_events(cls, events) -> "EventBlock":
        """Build a block from an Event run (tests / adapters; keys and
        timestamps must be int64-coercible)."""
        ts = np.fromiter((ev.ts for ev in events), np.int64, len(events))
        key = np.fromiter((ev.key for ev in events), np.int64, len(events))
        vals = [ev.value for ev in events]
        if all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in vals):
            return cls(ts, key, np.asarray(vals, np.float64), payload=vals)
        return cls(ts, key, None, payload=vals)

    def __repr__(self):  # pragma: no cover - debug aid
        n = len(self.ts)
        lo = self.ts[0] if n else "-"
        hi = self.ts[-1] if n else "-"
        return f"EventBlock(n={n}, ts=[{lo}..{hi}])"


def block_form(scalar_fn, block_fn):
    """Attach a vectorized form to a scalar stage function.

    ``block_fn`` contracts by stage kind: filter -> bool mask over the
    block's rows; map -> new value column (float64-coercible ndarray);
    rekey -> new key column (int64-coercible ndarray).  The fusion planner
    lowers a stateless chain to column ops only when EVERY step declares a
    block form; otherwise blocks explode to events at the chain boundary.
    """
    scalar_fn.__block_form__ = block_fn
    return scalar_fn


class Watermark:
    """Asserts that no event with ``ts < self.ts`` will arrive on this edge."""

    __slots__ = ("ts",)

    def __init__(self, ts: int):
        self.ts = ts

    def __repr__(self):  # pragma: no cover
        return f"Watermark({self.ts})"


class Barrier:
    """Chandy-Lamport snapshot barrier.

    ``snapshot_id`` increases monotonically per job.  ``terminal`` marks a
    snapshot taken for graceful job suspension (export-and-stop).
    """

    __slots__ = ("snapshot_id", "terminal")

    def __init__(self, snapshot_id: int, terminal: bool = False):
        self.snapshot_id = snapshot_id
        self.terminal = terminal

    def __repr__(self):  # pragma: no cover
        return f"Barrier({self.snapshot_id}{', terminal' if self.terminal else ''})"


class DoneItem:
    """End-of-stream marker for batch stages. A singleton per edge traversal."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover
        return "DONE"


DONE = DoneItem()


def is_special(item) -> bool:
    """True for control items (watermark / barrier / done)."""
    return isinstance(item, (Watermark, Barrier, DoneItem))
