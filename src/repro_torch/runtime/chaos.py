"""Seeded chaos layer: deterministic fault injection for self-healing
tests and soak runs.

A copy of ``repro/runtime/chaos.py``: the same seed gives the same
schedule in both packages, and the controller fires at the same logical
triggers.

The layer has three pieces, kept deliberately small:

* :class:`Fault` — one planned fault: *what* to inject (an abstract kind
  the backend translates: ``kill`` / ``stall`` / ``raise`` /
  ``drop_ack`` / ``delay_ack``), *where* (a worker index, resolved
  deterministically by the backend against its sorted live workers) and
  *when* — expressed as a **logical** trigger (the sink has produced at
  least ``at_result`` results, and at least one snapshot has committed —
  or, for the ack kinds, is at least in flight), not a wall-clock
  instant, so the same schedule hits comparable points of the
  computation on any substrate and at any machine speed.
* :class:`ChaosSchedule` — an ordered list of faults, either hand-built
  or derived entirely from an integer seed (:meth:`ChaosSchedule
  .from_seed`), so a failing run is reproduced by its seed alone.
* :class:`ChaosController` — the driver-loop hook: call :meth:`tick`
  once per scheduler iteration; it fires the next due fault through
  ``backend.inject_fault`` and records *when* it fired (wall clock and
  result count) for recovery-gap measurement.  Kinds a substrate cannot
  express (``inject_fault`` returning False — e.g. ``stall`` in-process)
  are recorded as skipped and the schedule moves on, so one schedule
  runs everywhere.

Faults only fire while the job is RUNNING — injecting into a job that is
already tearing down or backing off for a restart would chaos-test the
chaos layer, not the engine.
"""

from __future__ import annotations

import random
import time as _time
from typing import Dict, List, Optional, Sequence

from ..core.engine import JOB_RUNNING

#: fault kinds every schedule may draw from; backends translate each into
#: the realest failure they can produce and veto the rest
KIND_KILL = "kill"
KIND_STALL = "stall"
KIND_RAISE = "raise"
KIND_DROP_ACK = "drop_ack"
KIND_DELAY_ACK = "delay_ack"
ALL_KINDS = (KIND_KILL, KIND_STALL, KIND_RAISE, KIND_DROP_ACK,
             KIND_DELAY_ACK)

#: snapshot-corruption kinds: these hit the durable snapshot store on
#: disk (the chain head at fire time), not a worker — they are injected
#: by the controller itself, so they work on every backend but need a
#: :class:`~repro_torch.state.durable_store.DurableSnapshotStore`
KIND_CORRUPT_FLIP = "corrupt_flip"          # XOR one byte of a segment
KIND_CORRUPT_TRUNCATE = "corrupt_truncate"  # cut a segment file short
KIND_CORRUPT_MANIFEST = "corrupt_manifest"  # delete the manifest
CORRUPTION_KINDS = (KIND_CORRUPT_FLIP, KIND_CORRUPT_TRUNCATE,
                    KIND_CORRUPT_MANIFEST)


class Fault:
    """One planned fault (see module docstring for trigger semantics)."""

    __slots__ = ("kind", "at_result", "worker_index", "params",
                 "fired", "skipped", "fired_at", "fired_at_result")

    def __init__(self, kind: str, at_result: int, worker_index: int = 0,
                 params: Optional[Dict] = None):
        self.kind = kind
        self.at_result = at_result
        self.worker_index = worker_index
        self.params = params or {}
        self.fired = False
        #: True when the substrate could not express the kind
        self.skipped = False
        self.fired_at: Optional[float] = None
        self.fired_at_result: Optional[int] = None

    def __repr__(self):
        state = ("fired" if self.fired else
                 "skipped" if self.skipped else "pending")
        return (f"Fault({self.kind}@{self.at_result}"
                f"+w{self.worker_index}, {state})")


class ChaosSchedule:
    """An ordered fault plan.  ``from_seed`` derives the whole plan —
    kinds, injection points, target workers — from one integer, which is
    all a failing run needs to be replayed."""

    __slots__ = ("faults", "seed")

    def __init__(self, faults: Sequence[Fault], seed: Optional[int] = None):
        self.faults = sorted(faults, key=lambda f: f.at_result)
        self.seed = seed

    @classmethod
    def from_seed(cls, seed: int, n_faults: int, total_results: int,
                  kinds: Sequence[str] = ALL_KINDS,
                  lo_frac: float = 0.1, hi_frac: float = 0.7,
                  stall_duration_s: float = 0.5,
                  ack_delay_s: float = 0.3) -> "ChaosSchedule":
        """Derive ``n_faults`` faults spread over the logical interval
        ``[lo_frac, hi_frac] * total_results`` (the tail is left quiet so
        every fault has room to recover inside the run)."""
        rng = random.Random(seed)
        lo = max(1, int(total_results * lo_frac))
        hi = max(lo + 1, int(total_results * hi_frac))
        points = sorted(rng.sample(range(lo, hi), min(n_faults, hi - lo)))
        # cycle the kinds in a seed-shuffled order: n_faults >= len(kinds)
        # guarantees every kind fires at least once per schedule
        order = list(kinds)
        rng.shuffle(order)
        faults = []
        for i, at in enumerate(points):
            kind = order[i % len(order)]
            params: Dict = {}
            if kind == KIND_STALL:
                params["duration_s"] = stall_duration_s
            elif kind == KIND_DELAY_ACK:
                params["delay_s"] = ack_delay_s
            faults.append(Fault(kind, at,
                                worker_index=rng.randrange(0, 1 << 16),
                                params=params))
        return cls(faults, seed=seed)

    @classmethod
    def corruption_from_seed(cls, seed: int, n_faults: int,
                             total_results: int,
                             kinds: Sequence[str] = CORRUPTION_KINDS,
                             lo_frac: float = 0.15,
                             hi_frac: float = 0.7) -> "ChaosSchedule":
        """Corruption plan: each corruption fault is immediately chased
        by a ``kill`` at the same logical point, so the very next
        recovery must restore *through* the snapshot that was just
        corrupted — forcing the verified-fallback path rather than
        letting a later commit quietly replace the damaged head.  The
        controller fires both back-to-back within one tick (no commit
        can slip between them)."""
        rng = random.Random(seed)
        lo = max(1, int(total_results * lo_frac))
        hi = max(lo + 1, int(total_results * hi_frac))
        points = sorted(rng.sample(range(lo, hi), min(n_faults, hi - lo)))
        order = list(kinds)
        rng.shuffle(order)
        faults = []
        for i, at in enumerate(points):
            faults.append(Fault(order[i % len(order)], at,
                                worker_index=rng.randrange(0, 1 << 16)))
            faults.append(Fault(KIND_KILL, at,
                                worker_index=rng.randrange(0, 1 << 16)))
        return cls(faults, seed=seed)

    def pending(self) -> Optional[Fault]:
        for f in self.faults:
            if not f.fired and not f.skipped:
                return f
        return None

    @property
    def done(self) -> bool:
        return self.pending() is None

    def fired(self) -> List[Fault]:
        return [f for f in self.faults if f.fired]


def corrupt_snapshot(store, job_id: str, snapshot_id: int, kind: str,
                     index: int = 0) -> bool:
    """Damage one on-disk snapshot the way real storage does: flip a byte
    mid-segment, truncate a segment, or lose the manifest.  ``store``
    must expose the durable path helpers
    (:class:`~repro_torch.state.durable_store.DurableSnapshotStore`).  Returns
    False when the damage could not be applied."""
    if kind == KIND_CORRUPT_MANIFEST:
        try:
            store.manifest_path(job_id, snapshot_id).unlink()
            return True
        except OSError:
            return False
    segs = store.segment_paths(job_id, snapshot_id)
    if not segs:
        return False
    path = segs[index % len(segs)]
    try:
        size = path.stat().st_size
        if kind == KIND_CORRUPT_FLIP:
            if size == 0:
                return False
            with open(path, "r+b") as f:
                f.seek(size // 2)
                byte = f.read(1)
                f.seek(size // 2)
                f.write(bytes([byte[0] ^ 0xFF]))
            return True
        if kind == KIND_CORRUPT_TRUNCATE:
            with open(path, "r+b") as f:
                f.truncate(max(0, size // 2))
            return True
    except OSError:
        return False
    return False


class ChaosController:
    """Fires a :class:`ChaosSchedule` into one job from the driver loop.

    ``sink`` is the results list whose length is the logical clock
    (``Fault.at_result`` triggers); ``require_snapshot`` gates disruptive
    kinds (kill/stall/raise) until the first snapshot committed, so a
    kill always exercises the restore path rather than a from-scratch
    replay.  Ack faults (drop/delay) instead gate on a barrier being *in
    flight* (``ssctx.requested_id >= 1``): a commit is exactly what they
    sabotage, and on a slow or loaded machine the first commit may never
    beat its own ack deadline — waiting for it would mean the fault
    never fires at all."""

    __slots__ = ("cluster", "job", "sink", "schedule", "require_snapshot",
                 "log")

    def __init__(self, cluster, job, sink: list, schedule: ChaosSchedule,
                 require_snapshot: bool = True):
        self.cluster = cluster
        self.job = job
        self.sink = sink
        self.schedule = schedule
        self.require_snapshot = require_snapshot
        #: chronological record of fired/skipped faults (the harness's
        #: ground truth for recovery-gap attribution)
        self.log: List[Fault] = []

    def tick(self) -> bool:
        """Fire the next due fault, if any.  Returns True when a fault
        was injected this call.

        A fired *corruption* fault keeps the loop going, so the fault
        scheduled at the same logical point (its paired ``kill``) lands
        in the same tick: no ``cluster.step()`` — and therefore no
        commit that would replace the corrupted chain head — can run
        between the damage and the failure that must recover through
        it."""
        fired_any = False
        while True:
            fault = self.schedule.pending()
            if fault is None:
                return fired_any
            job = self.job
            if job.status != JOB_RUNNING or job.execution is None:
                return fired_any
            if len(self.sink) < fault.at_result:
                return fired_any
            if fault.kind in CORRUPTION_KINDS:
                injected = self._inject_store_fault(fault)
                if injected is None:
                    # no committed chain head yet: stay pending
                    return fired_any
            else:
                if self.require_snapshot and job.snapshots_taken < 1:
                    ssctx = getattr(job.execution, "ssctx", None)
                    barrier_inflight = (
                        fault.kind in (KIND_DROP_ACK, KIND_DELAY_ACK)
                        and getattr(ssctx, "requested_id", 0) >= 1)
                    if not barrier_inflight:
                        return fired_any
                injected = self.cluster.backend.inject_fault(
                    job.execution, fault.kind, fault.worker_index,
                    **fault.params)
            if not injected:
                fault.skipped = True
                self.log.append(fault)
                return fired_any
            fault.fired = True
            fault.fired_at = _time.monotonic()
            fault.fired_at_result = len(self.sink)
            self.log.append(fault)
            fired_any = True
            if fault.kind not in CORRUPTION_KINDS:
                return fired_any

    def _inject_store_fault(self, fault: Fault):
        """Corrupt the durable chain head on disk.  True = injected,
        False = the store cannot express the kind (skipped), None = no
        committed chain head yet (fault stays pending)."""
        store = getattr(self.cluster, "snapshot_store", None)
        if not hasattr(store, "segment_paths"):
            return False
        chain = store.recovery_chain(self.job.id)
        if not chain:
            return None
        sid = chain[0]
        ok = corrupt_snapshot(store, self.job.id, sid, fault.kind,
                              index=fault.worker_index)
        if ok:
            # record the victim epoch for recovery-gap attribution
            fault.params["snapshot_id"] = sid
        return ok
