"""Shared-memory SPSC ring buffer: the cross-process edge transport.

A copy of ``repro/core/shm_ring.py`` (plain Python, no framework), with
two deliberate differences.  The segment name prefix
(:data:`RING_NAME_PREFIX`) is ``jtorch_ring_``, not the reference's
``jetring_``.  The reference's :func:`sweep_leaked_rings` unlinks every
segment on the host whose name starts with its prefix, and its tests
assert that no such segment exists once their jobs are down; sharing
the prefix would let either package's sweep unlink the other's live
rings when both run at once on one host (test files run in parallel
processes), and would fail the reference's leak check.  And the four
header words (the cursors and the message counters) are read and
written through int64 numpy views of the header, one aligned 8-byte
load or store each.  The reference packs them with ``struct``, whose
copies are not single stores and loads (a process reading a word while
another writes it was measured to see a mix of the two values), so
under load its consumer can read a torn ``tail`` ahead of the
producer's and decode a record that is not written yet, or a stale one
from the ring's previous lap (ROADMAP.md §3, F5).  On a little-endian
host the header bytes are the same.  The ring layout, the record tags
and the record header are the reference's byte for byte, so the
reference's ring sanitizer model (``repro.analysis.ring_sanitizer``)
describes this ring as exactly; its assumption that a cursor store is
atomic now holds.

Under the multiprocess backend every edge whose producer and consumer
tasklets live in different worker processes is a :class:`ShmRing` — one
``multiprocessing.shared_memory`` segment holding a byte-level ring of
length-prefixed records.  EventBlocks travel as raw column slabs (the
:meth:`EventBlock.to_wire` format: ts/key/value int64/float64 bytes copied
straight out of the numpy buffers), while watermarks, barriers, DONE and
scalar stragglers ride a small tagged control lane — so the columnar hot
path never pays per-row pickling.

Memory model
============

The ring is strictly SPSC: exactly one producer process writes records and
advances ``tail``; exactly one consumer process reads records and advances
``head``.  Both cursors are monotonically increasing byte offsets stored as
aligned 8-byte little-endian integers in the segment header.  On x86-64
(TSO) an aligned 8-byte store is atomic and stores are not reordered, and
CPython's ``struct.pack_into`` performs the payload stores before the
cursor store crosses the interpreter boundary — the same publication
pattern every pure-Python shm ring uses.  ``offer``/``poll`` never block;
``offer`` returning ``False`` is the backpressure signal, exactly the
:class:`~repro_torch.core.queues.SPSCQueue` contract.

This argument is machine-checked twice over (ROADMAP "Machine-checked
contracts"): statically, jetlint's ``ring-role-violation`` pass
(``repro.analysis.ring_roles``) verifies the SPSC role split — producer
methods own ``tail`` and the bytes they stage, consumer methods own
``head``, no attribute or header word has two writing sides, and no
process role holds both ends of a ring; dynamically, the ring sanitizer
(``python -m repro.analysis.ring_sanitizer``) exhaustively interleaves
the exact ``offer`` mutation order modeled below (pad header, record
header, payload, ``msgs_in``, ``tail``) against atomic polls with a
producer crash injected at every step boundary, asserting no
torn/lost/duplicated record ever becomes observable.

Record layout
=============

``[u32 total_len][u8 tag][payload]`` — ``total_len`` includes the 5-byte
header.  Records never wrap: when the contiguous space to the physical end
of the data region cannot hold a record, a PAD record (or a bare tail gap
of < 5 bytes) fills it and the record starts at offset 0, keeping every
payload contiguous for ``np.frombuffer``.  A record larger than the data
region is a hard error — size rings to a few multiples of the largest
block (the default 1 MiB holds ~6 full 4096-row NEXMark blocks).

``has_room_for(item)`` serializes the item once, caches the encoding, and
answers whether an ``offer`` of that item is guaranteed to succeed — the
all-or-nothing admission primitive EventBlock routing needs on an edge
whose capacity is bytes, not slots.

Leak guards
===========

A shm segment outlives the process that forgot to unlink it, so rings
created here carry three layers of protection:

* every segment is named ``jtorch_ring_<creator-pid>_<nonce>``
  (:data:`RING_NAME_PREFIX`), so leaked segments are identifiable;
* the creating :class:`ShmRing` registers a ``weakref.finalize`` (which
  also runs at interpreter exit) that unlinks the segment if normal
  teardown never did; the callback is guarded by the creator's pid —
  worker processes inherit the object via fork and must NOT unlink a
  segment the coordinator is still using when they exit;
* :func:`sweep_leaked_rings` removes any ``jtorch_ring_*`` segment left on
  the host by previous crashed runs (a SIGKILL'd coordinator gets no
  atexit), for harnesses/CI to call up front.
"""

from __future__ import annotations

import os
import pickle
import secrets
import struct
import weakref
from multiprocessing import shared_memory
from typing import Any, List, Optional, Tuple

import numpy as np

from .events import (Barrier, DONE, DoneItem, Event, EventBlock, LateEvent,
                     Watermark)

#: record tags
TAG_PICKLE = 0          # arbitrary item (pickle payload)
TAG_BLOCK = 1           # EventBlock.to_wire payload
TAG_EVENT = 2           # Event with int ts/key and int-or-float value
TAG_WATERMARK = 3       # int64 ts
TAG_BARRIER = 4         # int64 snapshot_id + u8 terminal
TAG_DONE = 5            # empty payload
TAG_PAD = 255           # fill to the physical end; carries no item

_HDR_BYTES = 64         # segment header: head @0, tail @8, msgs @16/@24
_REC = struct.Struct("<IB")
_Q = struct.Struct("<q")
_EVT_I = struct.Struct("<qqqB")     # ts, key, int value
_EVT_F = struct.Struct("<qqdB")     # ts, key, float value
_BARRIER = struct.Struct("<qB")
_PICKLE_PROTO = pickle.HIGHEST_PROTOCOL

DEFAULT_RING_BYTES = 1 << 20

#: shm segment name prefix for every ring created by this module
RING_NAME_PREFIX = "jtorch_ring_"
_SHM_DIR = "/dev/shm"


def _unlink_guarded(name: str, creator_pid: int) -> None:
    """Finalizer body: unlink ``name`` only in the process that created
    it.  Children inherit the creator's ShmRing (and its finalizer) via
    fork; a child exiting mid-job must not yank the segment out from
    under the coordinator."""
    if os.getpid() != creator_pid:
        return
    try:
        seg = shared_memory.SharedMemory(name=name)
    except (FileNotFoundError, OSError):
        return      # already unlinked by normal teardown
    try:
        seg.unlink()
    except (FileNotFoundError, OSError):  # pragma: no cover - racing exit
        pass
    finally:
        seg.close()


def sweep_leaked_rings() -> List[str]:
    """Remove ``jtorch_ring_*`` segments left behind by previous crashed runs
    (a SIGKILL'd process gets neither atexit nor finalizers).  Returns
    the names removed.  Call this up front in long-running harnesses —
    never mid-job, when live rings with the prefix exist."""
    swept: List[str] = []
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:  # pragma: no cover - non-Linux / no shm mount
        return swept
    for fn in names:
        if fn.startswith(RING_NAME_PREFIX):
            try:
                os.unlink(os.path.join(_SHM_DIR, fn))
                swept.append(fn)
            except OSError:  # pragma: no cover - racing teardown
                pass
    return swept


def _encode(item) -> Tuple[int, bytes]:
    cls = item.__class__
    if cls is EventBlock:
        return TAG_BLOCK, item.to_wire()
    if cls is Event:
        ts, key, value = item.ts, item.key, item.value
        if type(ts) is int and type(key) is int:
            if type(value) is int and -(2**62) < value < 2**62:
                return TAG_EVENT, _EVT_I.pack(ts, key, value, 0)
            if type(value) is float:
                return TAG_EVENT, _EVT_F.pack(ts, key, value, 1)
    if cls is Watermark:
        return TAG_WATERMARK, _Q.pack(item.ts)
    if cls is Barrier:
        return TAG_BARRIER, _BARRIER.pack(item.snapshot_id,
                                          1 if item.terminal else 0)
    if cls is DoneItem:
        return TAG_DONE, b""
    return TAG_PICKLE, pickle.dumps(item, protocol=_PICKLE_PROTO)


def _decode(tag: int, payload) -> Any:
    if tag == TAG_BLOCK:
        return EventBlock.from_wire(payload)
    if tag == TAG_EVENT:
        if payload[-1]:
            ts, key, value, _ = _EVT_F.unpack(payload)
        else:
            ts, key, value, _ = _EVT_I.unpack(payload)
        return Event(ts, key, value)
    if tag == TAG_WATERMARK:
        return Watermark(_Q.unpack(payload)[0])
    if tag == TAG_BARRIER:
        sid, terminal = _BARRIER.unpack(payload)
        return Barrier(sid, bool(terminal))
    if tag == TAG_DONE:
        return DONE
    return pickle.loads(payload)


class ShmRing:
    """Fixed-capacity shared-memory SPSC ring with the SPSCQueue surface."""

    __slots__ = ("_shm", "_cap", "_mv", "_head_w", "_tail_w", "_in_w",
                 "_out_w", "_data", "_created", "_staged", "_peeked",
                 "_finalizer", "name", "__weakref__")

    def __init__(self, capacity_bytes: int = DEFAULT_RING_BYTES,
                 name: Optional[str] = None, create: bool = True):
        self._finalizer = None
        if create:
            if name is None:
                name = (f"{RING_NAME_PREFIX}{os.getpid()}_"
                        f"{secrets.token_hex(4)}")
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=_HDR_BYTES + capacity_bytes)
            self._shm.buf[:_HDR_BYTES] = b"\x00" * _HDR_BYTES
            # leak guard: runs at GC or interpreter exit if stop_execution
            # never unlinked this ring; pid-guarded against forked children
            self._finalizer = weakref.finalize(
                self, _unlink_guarded, self._shm.name, os.getpid())
        else:
            self._shm = shared_memory.SharedMemory(name=name)
        self.name = self._shm.name
        self._created = create
        self._cap = self._shm.size - _HDR_BYTES
        self._mv = self._shm.buf
        # head, tail, msgs_in, msgs_out: an int64 view of each header word
        # (one aligned 8-byte load or store per access), one writing side
        # each
        self._head_w, self._tail_w, self._in_w, self._out_w = (
            np.ndarray((1,), dtype=np.int64, buffer=self._shm.buf,
                       offset=8 * i) for i in range(4))
        self._data = self._shm.buf[_HDR_BYTES:]
        #: producer-side staged encoding: (item, tag, payload).  The item
        #: itself is held, not its ``id``: an item whose offer failed and
        #: that was then dropped frees its id for the next object, which
        #: would be sent with the dropped item's bytes (ROADMAP.md §3, F5)
        self._staged: Optional[Tuple[Any, int, bytes]] = None
        #: consumer-side lookahead for peek()
        self._peeked = None

    # -- header cursors ------------------------------------------------------
    def _head(self) -> int:
        return self._head_w.item(0)

    def _tail(self) -> int:
        return self._tail_w.item(0)

    def _set_head(self, v: int) -> None:
        self._head_w[0] = v

    def _set_tail(self, v: int) -> None:
        self._tail_w[0] = v

    def _msgs_in(self) -> int:
        return self._in_w.item(0)

    def _msgs_out(self) -> int:
        return self._out_w.item(0)

    # -- producer side -------------------------------------------------------
    def _stage(self, item) -> Tuple[int, bytes]:
        staged = self._staged
        if staged is not None and staged[0] is item:
            return staged[1], staged[2]
        tag, payload = _encode(item)
        self._staged = (item, tag, payload)
        return tag, payload

    def _space_needed(self, tail: int, rec: int) -> int:
        to_end = self._cap - (tail % self._cap)
        return rec if rec <= to_end else to_end + rec

    def has_room_for(self, item) -> bool:
        """True when an immediate ``offer(item)`` is guaranteed to succeed.
        Serializes (and caches) the item; in SPSC use free space only grows
        between this call and the offer, so the answer cannot go stale."""
        tag, payload = self._stage(item)
        rec = _REC.size + len(payload)
        if rec > self._cap:
            raise ValueError(
                f"item of {rec} bytes exceeds ring capacity {self._cap}")
        free = self._cap - (self._tail() - self._head())
        return self._space_needed(self._tail(), rec) <= free

    def offer(self, item) -> bool:
        """Enqueue ``item``; returns False (backpressure) when full."""
        tag, payload = self._stage(item)
        rec = _REC.size + len(payload)
        if rec > self._cap:
            raise ValueError(
                f"item of {rec} bytes exceeds ring capacity {self._cap}")
        tail = self._tail()
        free = self._cap - (tail - self._head())
        if self._space_needed(tail, rec) > free:
            return False
        cap, data = self._cap, self._data
        idx = tail % cap
        to_end = cap - idx
        if rec > to_end:
            # close out the physical tail with a PAD record (or leave the
            # < 5-byte remainder implicit) and restart at offset 0
            if to_end >= _REC.size:
                _REC.pack_into(data, idx, to_end, TAG_PAD)
            tail += to_end
            idx = 0
        _REC.pack_into(data, idx, rec, tag)
        data[idx + _REC.size:idx + rec] = payload
        self._in_w[0] = self._msgs_in() + 1
        self._set_tail(tail + rec)
        self._staged = None
        return True

    def offer_many(self, items: List[Any], start: int = 0,
                   end: Optional[int] = None) -> int:
        n = len(items) if end is None else end
        i = start
        while i < n and self.offer(items[i]):
            i += 1
        return i - start

    def remaining_capacity(self) -> int:
        """Approximate free *item* slots (free bytes over a nominal record
        size).  Use :meth:`has_room_for` for admission decisions — byte
        capacity does not translate exactly into slots."""
        free = self._cap - (self._tail() - self._head())
        return free // 256

    # -- consumer side -------------------------------------------------------
    def _read_record(self, advance: bool):
        """Next (item, consumed_bytes) or None; skips PAD records."""
        head = self._head()
        cap, data = self._cap, self._data
        while True:
            if head == self._tail():
                return None
            idx = head % cap
            to_end = cap - idx
            if to_end < _REC.size:
                head += to_end          # implicit pad at the physical tail
                continue
            rec, tag = _REC.unpack_from(data, idx)
            if tag == TAG_PAD:
                head += rec
                continue
            item = _decode(tag, bytes(data[idx + _REC.size:idx + rec]))
            if advance:
                self._out_w[0] = self._msgs_out() + 1
                self._set_head(head + rec)
            return item, head + rec

    def poll(self) -> Optional[Any]:
        if self._peeked is not None:
            item = self._peeked[0]
            self._peeked = None
            return item
        got = self._read_record(advance=True)
        return got[0] if got is not None else None

    def peek(self) -> Optional[Any]:
        if self._peeked is None:
            got = self._read_record(advance=True)
            if got is None:
                return None
            self._peeked = got
        return self._peeked[0]

    def poll_many(self, limit: int) -> List[Any]:
        out = []
        while len(out) < limit:
            item = self.poll()
            if item is None:
                break
            out.append(item)
        return out

    def poll_prefix(self, limit: int,
                    explode_blocks: bool = False) -> Tuple[List[Any], Any]:
        """Batched control-aware drain; see ``SPSCQueue.poll_prefix``:
        dequeues the leading run of data items (a block counts as one slot)
        plus at most one trailing control item."""
        events: List[Any] = []
        ctrl = None
        n = 0
        while n < limit:
            item = self.poll()
            if item is None:
                break
            n += 1
            cls = item.__class__
            if cls is EventBlock:
                if explode_blocks:
                    events.extend(item.to_events())
                else:
                    events.append(item)
            elif cls is Event or isinstance(item, Event):
                events.append(item)
            else:
                ctrl = item
                break
        return events, ctrl

    def drain_to(self, sink: list, limit: int) -> int:
        items = self.poll_many(limit)
        sink.extend(items)
        return len(items)

    # -- shared --------------------------------------------------------------
    def __len__(self) -> int:
        n = self._msgs_in() - self._msgs_out()
        return n + (1 if self._peeked is not None else 0)

    @property
    def capacity(self) -> int:
        return self._cap

    def is_empty(self) -> bool:
        return len(self) == 0

    def is_full(self) -> bool:
        return self._cap - (self._tail() - self._head()) < _REC.size + 1

    # -- lifecycle -----------------------------------------------------------
    def attach(self) -> "ShmRing":
        """Open the same segment by name (the other process's end)."""
        return ShmRing(name=self.name, create=False)

    def close(self) -> None:
        self._peeked = None
        # drop the views before the mapping goes
        self._head_w = self._tail_w = self._in_w = self._out_w = None
        self._data.release()
        try:
            self._shm.close()
        except BufferError:  # pragma: no cover - interpreter-version quirk
            pass

    def unlink(self) -> None:
        if self._finalizer is not None:
            self._finalizer.detach()    # normal teardown; guard not needed
        try:
            self._shm.unlink()
        except FileNotFoundError:  # pragma: no cover - already unlinked
            pass

    def __reduce__(self):  # pragma: no cover - defensive
        raise TypeError("ShmRing is shared by inheritance (fork), not pickle")
