"""NEXMark's event stream as numpy columns, and a replayable pool of it.

A frozen copy of the arithmetic of ``repro_torch/nexmark/generator.py``'s
``NexmarkGenerator.gen_block`` (splitmix64 over the sequence number, the
standard mix of 1 person : 3 auctions : 46 bids in every 50 events,
uniform auction ids), kept here so that a change to the program cannot
change the benchmark's inputs.  It differs from the program's generator in
two ways, both stated in the configuration files:

* sequence numbers start at an offset drawn from the seed (a multiple of
  50, so every seed sees the same mix at the same positions, and so the
  same number of bids in every frame) and event time starts at 0;
* event time is integer arithmetic, ``ts = i * slide_ms // events_per_frame``
  for the ``i``-th event, so frame ``f`` holds exactly events
  ``[f * events_per_frame, (f + 1) * events_per_frame)``.

Only bids are valid for Q5.  An auction id ``a`` goes to key bucket
``(a * bucket_multiplier) % n_key_buckets``: an odd multiplier is a
bijection of ``[0, n_key_buckets)`` for a power-of-two bucket count, which
stands for Jet's hashing of keys to partitions.

:class:`ReplayPool` holds ``pool_steps`` steps of ``frames_per_step``
frames, generated once; step ``i`` of a run replays pool step ``i %
pool_steps`` with its timestamps shifted by whole pool cycles, so the only
per-step work of the source is that shift.  The stream is read by
``instances`` parallel source instances, as Jet's sources read partitions:
instance ``r`` reads the events ``i`` with ``i % instances == r``, in
event-time order, so every instance spans the whole step's event time.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

PERSON, AUCTION, BID = 1, 3, 46
TOTAL = PERSON + AUCTION + BID

_U64 = np.uint64


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over a uint64 vector (wrapping arithmetic)."""
    x = x + _U64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def seq_offset(seed: int) -> int:
    """The first sequence number of seed ``seed``'s stream: a multiple of
    50 below 50 * 2^40, so the mix's phase is the same for every seed."""
    with np.errstate(over="ignore"):
        h = int(mix64(np.array([seed & (2**64 - 1)], dtype=_U64))[0])
    return (h % 2**40) * TOTAL


def events(cfg: Dict, seed: int, idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Events ``idx`` (int64 positions from the stream's start) of seed
    ``seed``'s stream under configuration ``cfg``: the columns the source
    hands the program (``ts`` and ``key`` int32, ``value`` float32,
    ``valid`` bool) and the raw ``auction`` id and ``kind`` (0 person, 1
    auction, 2 bid)."""
    idx = np.asarray(idx, np.int64)
    seq = (idx + seq_offset(seed)).astype(_U64)
    with np.errstate(over="ignore"):
        r = mix64(seq)
    slot = (seq % _U64(TOTAL)).astype(np.int64)
    kind = np.where(slot >= PERSON + AUCTION, 2,
                    np.where(slot < PERSON, 0, 1)).astype(np.int8)
    auction = (r % _U64(cfg["n_auctions"])).astype(np.int64)
    key = (auction * cfg["assumed"]["bucket_multiplier"]) \
        % cfg["n_key_buckets"]
    ts = idx * cfg["slide_ms"] // cfg["events_per_frame"]
    return {"ts": ts.astype(np.int32), "key": key.astype(np.int32),
            "value": np.ones(len(idx), np.float32), "valid": kind == 2,
            "auction": auction, "kind": kind}


class ReplayPool:
    """``pool_steps`` steps of the stream, generated once from the seed,
    replayed cyclically: source instance ``instance``'s rows of every step
    (all of them with one instance)."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int,
                 instance: int = 0, instances: int = 1):
        self.frames_per_step = int(traffic["frames_per_step"])
        self.steps = int(traffic["pool_steps"])
        self.batch = self.frames_per_step * int(cfg["events_per_frame"])
        if self.batch % instances:
            raise ValueError(f"{instances} source instances must divide a "
                             f"step's {self.batch} events")
        self.rows = self.batch // instances
        self.offset = instance * self.rows
        idx = (np.arange(self.steps, dtype=np.int64)[:, None] * self.batch
               + instance
               + instances * np.arange(self.rows, dtype=np.int64)[None, :])
        ev = events(cfg, seed, idx.reshape(-1))
        self.cols = {k: ev[k] for k in ("ts", "key", "value", "valid")}
        #: event-time length of one pool cycle
        self.cycle_ms = self.steps * self.frames_per_step * int(
            cfg["slide_ms"])

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Step ``step``'s rows: views of the pool, with ``ts`` a fresh
        array shifted by the cycles before it."""
        j, cycle = step % self.steps, step // self.steps
        sl = slice(j * self.rows, (j + 1) * self.rows)
        ts = self.cols["ts"][sl] + np.int32(cycle * self.cycle_ms)
        return {"ts": ts, "key": self.cols["key"][sl],
                "value": self.cols["value"][sl],
                "valid": self.cols["valid"][sl]}

    def event_gen(self):
        """``run_stream``'s ``event_gen(start, size)``: ``start`` is the
        global offset of the rows asked for (a rank adds its slice's
        offset, ``rank * size``), ``size`` this instance's row count."""
        def gen(start: int, size: int) -> Dict[str, np.ndarray]:
            step, off = divmod(start, self.batch)
            if off != self.offset or size != self.rows:
                raise ValueError(f"rows [{off}, {off + size}) of a step: "
                                 f"this instance's slice is "
                                 f"[{self.offset}, {self.offset + self.rows})")
            return self.batch_at(step)
        return gen
