"""The port's shared-memory ring (``core/shm_ring.py``) against the JAX
package's.

The ring is plain Python in both packages; the port's copy differs only
in its segment name prefix.  The tests hold the port's ring to the
reference's: the same encodings and the same segment bytes for the same
offers, the same polled items under the same seeded interleavings, and
the reference's ring sanitizer model (``repro.analysis.ring_sanitizer``)
matching the port's cursors, counters and pads byte for byte.  Every
ring a test creates is unlinked by that test; the sweep test uses a
prefix of its own, so it never removes another process's rings.
"""

import gc
import os
import pickle
import random
import secrets

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.analysis import ring_sanitizer as rs  # noqa: E402
from repro.core import events as ref_events  # noqa: E402
from repro.core import shm_ring as ref_ring  # noqa: E402
from repro_torch.core import events as port_events  # noqa: E402
from repro_torch.core import shm_ring  # noqa: E402
from repro_torch.core.events import (  # noqa: E402
    Barrier, DONE, Event, EventBlock, LateEvent, Watermark)
from repro_torch.core.queues import SPSCQueue  # noqa: E402
from repro_torch.core.shm_ring import (  # noqa: E402
    DEFAULT_RING_BYTES, ShmRing, sweep_leaked_rings)


def _shm_names(prefix):
    try:
        return {fn for fn in os.listdir("/dev/shm") if fn.startswith(prefix)}
    except OSError:  # pragma: no cover - no shm mount
        return set()


@pytest.fixture
def rings():
    """Rings made through ``make(cap)``, each unlinked at the end."""
    made = []

    def make(cap, module=shm_ring):
        ring = module.ShmRing(capacity_bytes=cap)
        made.append(ring)
        return ring

    yield make
    for ring in made:
        try:
            ring.unlink()
        except Exception:
            pass
        try:
            ring.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# names: the one deliberate difference from the reference
# ---------------------------------------------------------------------------

def test_prefix_differs_from_the_reference():
    assert ref_ring.RING_NAME_PREFIX == "jetring_"
    assert not shm_ring.RING_NAME_PREFIX.startswith("jetring_")
    assert not ref_ring.RING_NAME_PREFIX.startswith(
        shm_ring.RING_NAME_PREFIX)


def test_ring_name_carries_the_port_prefix(rings):
    ring = rings(4096)
    assert ring.name.startswith(shm_ring.RING_NAME_PREFIX)
    assert ring.name.startswith(f"{shm_ring.RING_NAME_PREFIX}{os.getpid()}_")
    assert ring.name in _shm_names(shm_ring.RING_NAME_PREFIX)


def test_layout_constants_equal_the_reference():
    for name in ("TAG_PICKLE", "TAG_BLOCK", "TAG_EVENT", "TAG_WATERMARK",
                 "TAG_BARRIER", "TAG_DONE", "TAG_PAD", "_HDR_BYTES",
                 "DEFAULT_RING_BYTES"):
        assert getattr(shm_ring, name) == getattr(ref_ring, name), name
    for name in ("_REC", "_Q", "_EVT_I", "_EVT_F", "_BARRIER"):
        assert getattr(shm_ring, name).format == \
            getattr(ref_ring, name).format, name
    assert rs._REC.format == shm_ring._REC.format
    assert rs.TAG_PAD == shm_ring.TAG_PAD


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

def _block(ev, n=16, value=True, payload=None, cols=True):
    return ev.EventBlock(
        np.arange(n, dtype=np.int64) * 3,
        (np.arange(n, dtype=np.int64) * 7) % 5,
        np.arange(n, dtype=np.float64) * 1.5 if value else None,
        payload=payload,
        cols={"kind": np.arange(n, dtype=np.int8) % 3,
              "seq": np.arange(n, dtype=np.int64) + 1000} if cols else None)


def _assert_blocks_equal(a, b):
    assert a.ts.tolist() == b.ts.tolist()
    assert a.key.tolist() == b.key.tolist()
    if a.value is None:
        assert b.value is None
    else:
        assert a.value.tolist() == b.value.tolist()
    assert sorted(a.cols or {}) == sorted(b.cols or {})
    for name in a.cols or {}:
        assert a.cols[name].dtype == b.cols[name].dtype
        assert a.cols[name].tolist() == b.cols[name].tolist()


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="plain"),
    pytest.param({"value": False, "cols": False}, id="no_value_no_cols"),
    pytest.param({"n": 8, "payload": [f"v{i}" for i in range(8)]},
                 id="payload_list"),
])
def test_wire_roundtrip_and_bytes_equal_the_reference(kw):
    port, ref = _block(port_events, **kw), _block(ref_events, **kw)
    wire = port.to_wire()
    assert wire == ref.to_wire()
    out = EventBlock.from_wire(wire)
    _assert_blocks_equal(port, out)
    assert out.values() == port.values()


def test_wire_roundtrip_generator_block():
    from repro_torch.nexmark.generator import NexmarkGenerator
    gen = NexmarkGenerator(rate=1000, n_keys=10)
    blk = gen.gen_block(np.arange(50, dtype=np.int64))
    out = EventBlock.from_wire(blk.to_wire())
    _assert_blocks_equal(blk, out)
    assert [type(v).__name__ for v in out.values()] == \
        [type(v).__name__ for v in blk.values()]


def test_wire_copy_decouples_from_buffer():
    blk = _block(port_events)
    buf = bytearray(blk.to_wire())
    out = EventBlock.from_wire(buf)
    before = out.ts.tolist()
    buf[:] = b"\x00" * len(buf)
    assert out.ts.tolist() == before


def _item_pair(kind, i):
    """The same item built from the port's and from the reference's
    classes."""
    def make(ev):
        if kind == "event_int":
            return ev.Event(i, i % 13, i * 7 - 50)
        if kind == "event_float":
            return ev.Event(i, i % 13, i * 0.25)
        if kind == "watermark":
            return ev.Watermark(i * 3)
        if kind == "barrier":
            return ev.Barrier(i + 1, bool(i % 2))
        if kind == "done":
            return ev.DONE
        if kind == "block":
            return _block(ev, n=1 + i % 9, value=bool(i % 2))
        return ("tuple", i, [i * 0.5])
    return make(port_events), make(ref_events)


@pytest.mark.parametrize("kind", ["event_int", "event_float", "watermark",
                                  "barrier", "done", "block", "pickled"])
def test_encoding_equals_the_reference(kind):
    for i in range(5):
        port, ref = _item_pair(kind, i)
        assert shm_ring._encode(port) == ref_ring._encode(ref)


# ---------------------------------------------------------------------------
# ring basics
# ---------------------------------------------------------------------------

def test_ring_fifo_and_wraparound(rings):
    ring = rings(1 << 12)
    rng = random.Random(7)
    pending = []
    sent = recv = 0
    while sent < 3000 or pending:
        if sent < 3000 and (not pending or rng.random() < 0.6):
            if ring.offer(Event(sent, sent % 13, float(sent))):
                pending.append(sent)
                sent += 1
        else:
            got = ring.poll()
            if got is not None:
                assert got.ts == pending.pop(0)
                recv += 1
    assert recv == 3000 and ring.is_empty()


def test_ring_oversize_item_rejected(rings):
    ring = rings(1 << 12)
    big = EventBlock(np.arange(4096, dtype=np.int64),
                     np.arange(4096, dtype=np.int64))
    with pytest.raises(ValueError):
        ring.offer(big)
    with pytest.raises(ValueError):
        ring.has_room_for(big)


def test_ring_attach_sees_producer_writes(rings):
    ring = rings(1 << 12)
    other = ring.attach()
    try:
        assert ring.offer(Watermark(42))
        got = other.poll()
        assert isinstance(got, Watermark) and got.ts == 42
        assert ring.is_empty()
    finally:
        other.close()


def test_ring_not_picklable(rings):
    with pytest.raises(TypeError):
        pickle.dumps(rings(1 << 12))


def test_has_room_for_admission_guarantee(rings):
    ring = rings(1 << 12)
    blk = _block(port_events, 48)
    n = 0
    while ring.has_room_for(blk):
        assert ring.offer(blk)
        n += 1
        assert n < 100, "ring never filled"
    assert not ring.offer(blk)
    assert ring.poll() is not None
    assert ring.has_room_for(blk) and ring.offer(blk)


def test_default_ring_capacity_holds_full_blocks(rings):
    from repro_torch.nexmark.generator import NexmarkGenerator
    gen = NexmarkGenerator(rate=60_000)
    ring = rings(DEFAULT_RING_BYTES)
    n = 0
    blk = gen.gen_block(np.arange(4096, dtype=np.int64))
    while ring.has_room_for(blk):
        assert ring.offer(blk)
        n += 1
        blk = gen.gen_block(np.arange(4096, dtype=np.int64) + n * 4096)
    assert n >= 4
    for i in range(n):
        assert ring.poll().ts[0] == i * 4096 * 1000 // 60_000


# ---------------------------------------------------------------------------
# the port's ring against the reference's, under the same interleavings
# ---------------------------------------------------------------------------

def _canon(item):
    name = item.__class__.__name__
    if name == "EventBlock":
        return ("B", item.ts.tolist(), item.key.tolist(),
                None if item.value is None else item.value.tolist(),
                sorted((k, v.tolist()) for k, v in (item.cols or {}).items()))
    if name == "LateEvent":
        return ("L", item.ts, item.key, item.value)
    if name == "Event":
        return ("E", item.ts, item.key, item.value)
    if name == "Watermark":
        return ("W", item.ts)
    if name == "Barrier":
        return ("X", item.snapshot_id, item.terminal)
    if name == "DoneItem":
        return ("D",)
    return ("P", item)


def _random_item(rng, ev, late=True):
    """tests/test_shm_ring.py's item mix, built from ``ev``'s classes.
    A ``LateEvent`` travels pickled, and its pickle names its package's
    module, so a mix meant to give byte-equal segments in both packages
    (``late=False``) draws a pickled tuple in its place."""
    roll = rng.random()
    if roll < 0.45:
        value = (rng.randrange(-10**6, 10**6) if rng.random() < 0.5
                 else rng.random() * 100)
        return ev.Event(rng.randrange(10**6), rng.randrange(64), value)
    if roll < 0.70:
        n = rng.randrange(1, 40)
        return ev.EventBlock(
            np.sort(np.asarray([rng.randrange(10**6) for _ in range(n)],
                               dtype=np.int64)),
            np.asarray([rng.randrange(64) for _ in range(n)],
                       dtype=np.int64),
            np.asarray([rng.random() for _ in range(n)], dtype=np.float64)
            if rng.random() < 0.7 else None,
            cols={"seq": np.arange(n, dtype=np.int64)}
            if rng.random() < 0.5 else None)
    if roll < 0.80:
        return ev.Watermark(rng.randrange(10**6))
    if roll < 0.88:
        return ev.Barrier(rng.randrange(1, 100), rng.random() < 0.1)
    if roll < 0.92:
        return ev.DONE
    if roll < 0.96:
        ts, key = rng.randrange(10**6), rng.randrange(64)
        if not late:
            return ("late", ts, key)
        return ev.LateEvent(ts, key, "late")
    return ("tuple", rng.randrange(100), [rng.random()])


def _drive(ring, ev, seed, ops, cap_edge=False):
    """One seeded sequence of offers, polls, peeks and drains; returns
    every observation in order (admission answers, polled items, sizes)
    and the segment's bytes after each of a few checkpoints."""
    rng = random.Random(seed)
    seen = []
    for i in range(ops):
        op = rng.random()
        if op < (0.55 if cap_edge else 0.40):
            if cap_edge:
                item = (ev.Event(i, i % 7, float(i)) if rng.random() < 0.7
                        else ev.Watermark(i))
            else:
                item = _random_item(rng, ev, late=False)
            seen.append(("room", ring.has_room_for(item)))
            seen.append(("offer", ring.offer(item)))
        elif cap_edge or op < 0.60:
            got = ring.poll()
            seen.append(("poll", None if got is None else _canon(got)))
        elif op < 0.70:
            got = ring.peek()
            seen.append(("peek", None if got is None else _canon(got)))
        elif op < 0.80:
            got = ring.poll_many(rng.randrange(1, 8))
            seen.append(("many", [_canon(x) for x in got]))
        else:
            limit = rng.randrange(1, 8)
            events, ctrl = ring.poll_prefix(limit,
                                            explode_blocks=rng.random() < 0.5)
            seen.append(("prefix", [_canon(x) for x in events],
                         None if ctrl is None else _canon(ctrl)))
        seen.append(("len", len(ring), ring.is_empty(), ring.is_full()))
        if i % 97 == 0:
            seen.append(("bytes", bytes(ring._mv)))
    while True:
        got = ring.poll()
        if got is None:
            break
        seen.append(("tail", _canon(got)))
    seen.append(("bytes", bytes(ring._mv)))
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_random_interleavings_equal_the_reference(rings, seed):
    """The same seeded mix of offers, polls, peeks and control-aware
    drains (tests/test_shm_ring.py's oracle) through both rings: equal
    admission answers, equal polled items, and the whole segment (header
    and data) byte-equal at checkpoints."""
    port = _drive(rings(1 << 14), port_events, 1000 + seed, 2500)
    ref = _drive(rings(1 << 14, ref_ring), ref_events, 1000 + seed, 2500)
    assert port == ref
    offered = sum(1 for s in port if s == ("offer", True))
    polled = sum(1 for s in port if s[0] == "poll" and s[1] is not None)
    assert offered > 200 and polled > 100, "degenerate interleaving"


@pytest.mark.parametrize("seed", range(4))
def test_capacity_edge_equals_the_reference(rings, seed):
    """A tiny ring: constant full and empty transitions, PAD records and
    implicit tail gaps, in both packages alike."""
    port = _drive(rings(1 << 9), port_events, 7000 + seed, 4000,
                  cap_edge=True)
    ref = _drive(rings(1 << 9, ref_ring), ref_events, 7000 + seed, 4000,
                 cap_edge=True)
    assert port == ref
    assert sum(1 for s in port if s == ("offer", False)) > 50


@pytest.mark.parametrize("seed", range(3))
def test_ring_equals_spsc_queue(rings, seed):
    """The port's ring is the same FIFO transport as its SPSCQueue."""
    ring, queue = rings(1 << 14), SPSCQueue(64)
    rng = random.Random(50 + seed)
    model = []
    for _ in range(1500):
        if rng.random() < 0.5:
            item = _random_item(rng, port_events)
            if ring.has_room_for(item) and queue.has_room_for(item):
                assert ring.offer(item) and queue.offer(item)
                model.append(_canon(item))
        else:
            a, b = ring.poll(), queue.poll()
            assert (a is None) == (b is None)
            if a is not None:
                assert _canon(a) == _canon(b) == model.pop(0)
        assert len(ring) == len(queue) == len(model)


# ---------------------------------------------------------------------------
# the reference's sanitizer model describes the port's ring
# ---------------------------------------------------------------------------

def test_model_layout_matches_the_port_ring(rings):
    """tests/test_ring_sanitizer.py's fidelity check with the port's ring:
    size-matched records through wraparound; cursors, counters and pad
    placement agree with the model byte for byte."""
    items = [b"a" * 3, b"b" * 30, b"c" * 8, b"d" * 25, b"e" * 10]
    sizes = tuple(len(shm_ring._encode(it)[1]) for it in items)
    cap = 2 * (rs._REC.size + max(sizes))
    cfg = rs.Config(capacity=cap, sizes=sizes, init_byte=0)
    st = rs._State(cfg)
    ring = rings(cap)
    queue = list(range(len(items)))
    polled = []
    step = 0
    while queue or not ring.is_empty():
        step += 1
        offered = False
        if queue:
            plan = rs._plan_offer(st, cfg)
            ok = ring.offer(items[queue[0]])
            assert (plan is not None) == ok
            if ok:
                for op in plan:
                    rs._apply(st, op)
                st.p_idx += 1
                queue.pop(0)
                offered = True
        if not offered or step % 2:
            got = rs._poll(st, cap)
            real = ring.poll()
            assert (got is None) == (real is None)
            if got is not None:
                assert got[0] != "torn"
                polled.append(got)
                assert real == items[got[0]]
        assert ring._tail() == st.tail
        assert ring._head() == st.head
        assert ring._msgs_in() == st.msgs_in
        assert ring._msgs_out() == st.msgs_out
    assert [seq for seq, _ in polled] == list(range(len(items)))
    # every pad the model places exists in the port's buffer
    st2 = rs._State(cfg)
    ring2 = rings(cap)
    pads = 0
    for it in items:
        plan = rs._plan_offer(st2, cfg)
        while plan is None:
            got = rs._poll(st2, cap)
            assert got is not None and got[0] != "torn"
            assert ring2.poll() == items[got[0]]
            plan = rs._plan_offer(st2, cfg)
        assert ring2.offer(it)
        for op in plan:
            if op[0] == "pad":
                rec, tag = rs._REC.unpack_from(ring2._data.tobytes(), op[1])
                assert (rec, tag) == (op[2], shm_ring.TAG_PAD)
                pads += 1
            rs._apply(st2, op)
        st2.p_idx += 1
        assert ring2._tail() == st2.tail
    assert pads, "the script never crossed a PAD record"


@pytest.mark.parametrize("sizes", [(7, 12, 5, 9, 6, 15, 3) * 3,
                                   (3, 30, 8, 25, 10) * 3])
def test_model_replay_equals_port_and_reference_segments(rings, sizes):
    """The model's atomic replay of a script, and both packages' rings
    given records of the script's sizes: equal cursors and counters
    after every offer and poll, and the two segments byte-equal."""
    items = [bytes([97 + i % 26]) * n for i, n in enumerate(sizes)]
    enc = tuple(len(shm_ring._encode(it)[1]) for it in items)
    cap = 2 * (rs._REC.size + max(enc)) + 6
    cfg = rs.Config(capacity=cap, sizes=enc, init_byte=0)
    st = rs._State(cfg)
    port, ref = rings(cap), rings(cap, ref_ring)

    def same():
        assert (port._head(), port._tail(), port._msgs_in(),
                port._msgs_out()) == (st.head, st.tail, st.msgs_in,
                                      st.msgs_out)
        assert bytes(port._mv) == bytes(ref._mv)

    for it in items:
        plan = rs._plan_offer(st, cfg)
        while plan is None:
            got = rs._poll(st, cap)
            assert got is not None and got[0] != "torn"
            assert port.poll() == ref.poll() == items[got[0]]
            same()
            plan = rs._plan_offer(st, cfg)
        assert port.offer(it) and ref.offer(it)
        for op in plan:
            rs._apply(st, op)
        st.p_idx += 1
        same()
    while True:
        got = rs._poll(st, cap)
        if got is None:
            break
        assert port.poll() == ref.poll() == items[got[0]]
        same()
    assert port.poll() is None and ref.poll() is None


# ---------------------------------------------------------------------------
# leak guards, on rings this test creates only
# ---------------------------------------------------------------------------

def test_ring_finalizer_unlinks_on_gc():
    ring = ShmRing(capacity_bytes=4096)
    name = ring.name
    assert name in _shm_names(shm_ring.RING_NAME_PREFIX)
    del ring
    gc.collect()
    assert name not in _shm_names(shm_ring.RING_NAME_PREFIX)


def test_ring_unlink_is_idempotent_with_finalizer():
    ring = ShmRing(capacity_bytes=4096)
    name = ring.name
    ring.unlink()
    assert name not in _shm_names(shm_ring.RING_NAME_PREFIX)
    ring.close()
    del ring
    gc.collect()


def test_sweep_removes_leaked_rings_of_its_prefix_only(monkeypatch, rings):
    """A leaked ring under a prefix of this test's own is swept; a live
    ring under the port's prefix and one under the reference's survive."""
    live_port = rings(4096)
    live_ref = rings(4096, ref_ring)
    prefix = f"jtorch_sweeptest_{os.getpid()}_{secrets.token_hex(3)}_"
    monkeypatch.setattr(shm_ring, "RING_NAME_PREFIX", prefix)
    ring = ShmRing(capacity_bytes=4096)
    name = ring.name
    assert name.startswith(prefix)
    ring._finalizer.detach()
    ring.close()
    del ring
    gc.collect()
    assert name in _shm_names(prefix)       # leaked, as a crashed run's
    swept = sweep_leaked_rings()
    assert swept == [name]
    assert name not in _shm_names(prefix)
    for live in (live_port, live_ref):
        assert live.name in _shm_names(live.name)


# ---------------------------------------------------------------------------
# two processes: the header words are whole 8-byte accesses
# ---------------------------------------------------------------------------

def _produce(ring, n):
    i = 0
    while i < n:
        item = Watermark(i) if i % 3 else Event(i, i % 7, float(i))
        if ring.offer(item):
            i += 1


def _consume(ring, n, result):
    for i in range(n):
        while True:
            got = ring.poll()
            if got is not None:
                break
        if got.ts != i:
            result.put(("out of order", i, got.ts))
            return
    result.put(("ok", n, n))


def test_two_process_spsc_order_through_many_laps():
    """ROADMAP.md §3, F5: four producer/consumer process pairs race, each
    through its own 4 KB ring, for hundreds of laps; every item arrives
    once, in order.  With the reference's byte-by-byte cursor packing a
    consumer could read a torn ``tail`` and receive a record of the
    previous lap (about one pair in two under this load)."""
    import multiprocessing as mp
    ctx = mp.get_context("fork")
    n, pairs = 150_000, 4
    rings = [ShmRing(capacity_bytes=1 << 12) for _ in range(pairs)]
    result = ctx.Queue()
    procs = []
    try:
        for ring in rings:
            procs.append(ctx.Process(target=_produce, args=(ring, n)))
            procs.append(ctx.Process(target=_consume,
                                     args=(ring, n, result)))
        for proc in procs:
            proc.start()
        got = [result.get(timeout=240) for _ in rings]
        assert got == [("ok", n, n)] * pairs, got
    finally:
        for proc in procs:
            proc.join(timeout=10)
            if proc.is_alive():     # pragma: no cover - cleanup on failure
                proc.kill()
                proc.join()
        for ring in rings:
            ring.unlink()
            ring.close()
