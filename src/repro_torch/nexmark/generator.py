"""Deterministic NEXMark event generator (paper §7.1 configuration).

* 10,000 distinct keys for persons and auctions, drawn pseudo-randomly,
* configurable aggregate rate (events/second) — event time is the *ideal*
  emission instant ``ts_ms = seq * 1000 / rate``,
* the standard NEXMark mix: 1 person : 3 auctions : 46 bids per 50 events,
* pure function of ``seq`` -> replayable by construction.

Both generators expose a columnar form, ``gen_block(seqs) ->
EventBlock``: splitmix64 over a uint64 sequence vector produces the
identical (ts, key, value) triples as the scalar ``__call__``, with the
model objects materialized lazily (``payload_fn`` rebuilds the exact
object from the stored ``seq`` column only on the per-event fallback
path).  Blocks carry auxiliary columns ``kind`` (0 person / 1 auction /
2 bid), ``seq``, and ``bidder`` for vectorized stage functions.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

from ..core.events import EventBlock
from .model import Auction, Bid, CITIES, Person, US_STATES

PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
TOTAL_PROPORTION = PERSON_PROPORTION + AUCTION_PROPORTION + BID_PROPORTION

KIND_PERSON, KIND_AUCTION, KIND_BID = 0, 1, 2

_U64 = np.uint64
_MASK64 = _U64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: int) -> int:
    """splitmix64 finalizer: cheap deterministic pseudo-randomness."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _mix64_vec(x: np.ndarray) -> np.ndarray:
    """splitmix64 over a uint64 vector (wrapping arithmetic is native)."""
    x = (x + _U64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


class _SeqMaterializer:
    """Picklable ``payload_fn``: rebuilds the model object of block row
    ``i`` from its ``seq`` column through the scalar generator.  A plain
    closure would pin blocks to one process; this travels over the
    multiprocess backend's shared-memory rings."""

    __slots__ = ("gen",)

    def __init__(self, gen: "NexmarkGenerator"):
        self.gen = gen

    def __call__(self, blk: EventBlock, i: int) -> Any:
        return self.gen(int(blk.cols["seq"][i]))[2]


class NexmarkGenerator:
    """Callable ``gen(seq) -> (ts_ms, key, value)`` for the paced source."""

    def __init__(self, rate: float, n_keys: int = 10_000,
                 auction_filter_mod: int = 123):
        self.rate = rate
        self.n_keys = n_keys
        self.auction_filter_mod = auction_filter_mod

    def timestamp_ms(self, seq: int) -> int:
        return int(seq * 1000 / self.rate)

    def __call__(self, seq: int) -> Tuple[int, Any, Any]:
        ts = int(seq * 1000 / self.rate)
        # splitmix64 inlined: this is called once per generated event
        x = (seq + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        r = x ^ (x >> 31)
        slot = seq % TOTAL_PROPORTION
        if slot >= PERSON_PROPORTION + AUCTION_PROPORTION:
            # bids are 46/50 of the stream: branch for them first
            n = self.n_keys
            aid = r % n
            return ts, aid, Bid(aid, (r >> 16) % n,
                                100 + ((r >> 32) % 9900), ts)
        if slot < PERSON_PROPORTION:
            pid = r % self.n_keys
            v = Person(pid, f"person-{pid}", f"p{pid}@example.com",
                       CITIES[r % len(CITIES)],
                       US_STATES[(r >> 8) % len(US_STATES)], ts)
            return ts, pid, v
        aid = r % self.n_keys
        seller = (r >> 16) % self.n_keys
        v = Auction(aid, seller, (r >> 24) % 10, 100 + r % 900,
                    ts + 60_000, ts)
        return ts, aid, v

    # -- columnar form --------------------------------------------------------
    def gen_block(self, seqs) -> EventBlock:
        """Vectorized ``__call__`` over a sequence vector.

        ``ts``/``key`` match the scalar triples exactly; the ``value``
        column is the bid price (auction reserve for auctions, 0 for
        persons) and the model object of row *i* is rebuilt on demand by
        ``payload_fn`` from the ``seq`` column — bit-identical to the
        scalar path because it IS the scalar path.
        """
        seqs = np.asarray(seqs, dtype=np.int64)
        # ts = int(seq * 1000 / rate): seq*1000 is float64-exact for any
        # realistic run length, so the double rounding matches Python's
        ts = (seqs.astype(np.float64) * 1000.0 / self.rate).astype(np.int64)
        r = _mix64_vec(seqs.astype(_U64))
        slot = seqs % TOTAL_PROPORTION
        kind = np.where(
            slot >= PERSON_PROPORTION + AUCTION_PROPORTION, KIND_BID,
            np.where(slot < PERSON_PROPORTION, KIND_PERSON,
                     KIND_AUCTION)).astype(np.int8)
        n_keys = _U64(self.n_keys)
        key = (r % n_keys).astype(np.int64)
        bidder = ((r >> _U64(16)) % n_keys).astype(np.int64)
        price = (_U64(100) + ((r >> _U64(32)) % _U64(9900))).astype(np.int64)
        reserve = (_U64(100) + (r % _U64(900))).astype(np.int64)
        value = np.where(kind == KIND_BID, price,
                         np.where(kind == KIND_AUCTION, reserve, 0)
                         ).astype(np.float64)
        return EventBlock(
            ts, key, value, payload_fn=_SeqMaterializer(self),
            cols={"kind": kind, "seq": seqs, "bidder": bidder})


class DisorderedNexmarkGenerator:
    """Bounded-shuffle wrapper: the same events as ``inner``, emitted out of
    timestamp order with event-time skew bounded by ``max_skew_ms``.

    The sequence axis is cut into blocks of ``floor(max_skew_ms * rate /
    1000)`` events (the floor is what keeps the within-block timestamp
    spread at or under ``max_skew_ms``); each block is emitted in a seeded
    permutation of itself — the argsort of a splitmix64 rank vector, so
    the whole permutation is ONE vectorized op on the columnar path and
    the identical order on the scalar path.  Timestamps travel WITH their
    event (an event is early/late relative to its ideal emission slot), so
    the disordered stream contains exactly the ordered stream's events —
    window results must match the ordered run whenever the watermark lag
    covers the skew.  Pure function of ``seq`` given ``seed``: replayable,
    deterministic, parallelism-agnostic.

    Note: the permutation is block-local, so a run truncated mid-block
    draws a few tail events from beyond the cut (and omits their swapped
    counterparts).  For exact ordered-vs-disordered multiset equality,
    size runs to a multiple of ``self.block`` events.
    """

    def __init__(self, inner: NexmarkGenerator, max_skew_ms: int,
                 seed: int = 0):
        if max_skew_ms < 0:
            raise ValueError("max_skew_ms must be >= 0")
        self.inner = inner
        self.rate = inner.rate
        self.n_keys = inner.n_keys
        self.max_skew_ms = max_skew_ms
        self.seed = seed
        # events whose ideal timestamps span <= max_skew_ms of event time;
        # within-block ts spread is (block-1) * 1000/rate <= max_skew_ms
        self.block = max(1, int(max_skew_ms * inner.rate / 1000))
        self._perm_cache: dict = {}

    def timestamp_ms(self, seq: int) -> int:
        return self.inner.timestamp_ms(self._mapped(seq))

    def _perm(self, block_idx: int) -> np.ndarray:
        perm = self._perm_cache.get(block_idx)
        if perm is not None:
            return perm
        n = self.block
        # rank vector: splitmix64 of (seed, block, position); argsort is
        # the permutation (stable, so equal ranks break by position)
        base = _U64((_mix64(self.seed * 0x9E3779B97F4A7C15 + block_idx)))
        ranks = _mix64_vec(base + np.arange(n, dtype=_U64))
        perm = np.argsort(ranks, kind="stable").astype(np.int64)
        if len(self._perm_cache) >= 8:
            # block access is near-sequential: keep a small window
            self._perm_cache.pop(min(self._perm_cache))
        self._perm_cache[block_idx] = perm
        return perm

    def _mapped(self, seq: int) -> int:
        b, off = divmod(seq, self.block)
        return b * self.block + int(self._perm(b)[off])

    def __getstate__(self):
        # the permutation cache is pure derived data (~KBs of argsorts);
        # recompute after unpickling rather than shipping it per block
        state = self.__dict__.copy()
        state["_perm_cache"] = {}
        return state

    def __call__(self, seq: int) -> Tuple[int, Any, Any]:
        return self.inner(self._mapped(seq))

    # -- columnar form --------------------------------------------------------
    def gen_block(self, seqs) -> EventBlock:
        """Vectorized bounded shuffle: map the sequence vector through the
        block-local permutations (one argsort per touched block, cached),
        then delegate to the inner generator's columnar form."""
        seqs = np.asarray(seqs, dtype=np.int64)
        bsz = self.block
        blocks, offs = np.divmod(seqs, bsz)
        mapped = np.empty_like(seqs)
        # a burst touches very few distinct blocks (they are skew-sized)
        uniq = np.unique(blocks)
        for b in uniq.tolist():
            sel = blocks == b
            mapped[sel] = b * bsz + self._perm(b)[offs[sel]]
        return self.inner.gen_block(mapped)


def fill_journal(journal, generator, n_events: int) -> None:
    """Pre-materialize events into a replayable journal (FT tests).
    ``generator`` is a Nexmark or DisorderedNexmark generator."""
    for seq in range(n_events):
        ts, key, value = generator(seq)
        journal.append(ts, key, value)
