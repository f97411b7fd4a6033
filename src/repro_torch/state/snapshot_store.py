"""Snapshot storage on top of the IMap service (paper §2.4, §4.4).

Jet stores each job snapshot in an IMap whose partitioning matches the
computation's key partitioning, so a processor's state snapshot lives on
the same member as the processor (primary) plus its backups.  Snapshots are
two-phase: entries accumulate under an *ongoing* id and become visible to
recovery only after :meth:`commit` (all tasklets acked the barrier).

Recovery speaks to the store through three hooks that this in-memory
base class implements trivially and the durable subclass
(:class:`~repro_torch.state.durable_store.DurableSnapshotStore`) makes real:

* :meth:`recovery_chain` — candidate snapshot ids, newest first.  Here:
  at most the single committed id.  Durable: the on-disk retention chain.
* :meth:`verify` — integrity check before a restore is attempted.  Here:
  always passes (process memory does not rot within one process
  lifetime).  Durable: manifest + per-segment CRC32.
* :meth:`prepare_restore` — materialize the chosen snapshot for
  ``entries_for_partition``.  Here: a no-op (it is already the live
  IMap).  Durable: rebuild the IMap from verified disk segments.

The engine's ``Job._select_restore_snapshot`` walks the chain through
these hooks, so every backend and both store flavours share one recovery
path.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .imap import IMap, IMapService

#: value types that cannot alias live processor state
_ATOMIC = (int, float, str, bytes, bool, type(None))


def own_snapshot_value(value):
    """Snapshot-time defensive copy — the serialization a real IMap would
    perform.  Processors snapshot their live containers (frame rings,
    session maps) by reference and keep mutating them after the barrier;
    storing the reference lets post-barrier execution corrupt the
    committed snapshot (rewound scalar fields next to advanced dicts), so
    the writer must take ownership at ``put`` time."""
    if type(value) in _ATOMIC:
        return value
    return copy.deepcopy(value)


class SnapshotWriter:
    """Tasklets write through this; bound to one (job, snapshot) epoch.

    Entries are stored under ``(vertex, instance, key)``: two parallel
    instances of one vertex may legitimately hold state under the SAME
    state key (e.g. the per-node stage-1 window accumulators' partials for
    one (key, frame)), and without the instance discriminator the second
    ``put`` silently overwrote the first — restored state lost one
    instance's share.  Recovery strips the discriminator and hands every
    entry to the new owner, whose ``restore_from_snapshot`` merges shards
    of one key (the documented restore contract).
    """

    def __init__(self, store: "SnapshotStore", job_id: str):
        self.store = store
        self.job_id = job_id

    def put(self, snapshot_id: int, vertex: str, key, value, pid: int,
            instance: int = 0) -> None:
        imap = self.store._map(self.job_id, snapshot_id)
        imap.put_with_pid((vertex, instance, key), own_snapshot_value(value),
                          pid)

    def put_many(self, entries: Iterable[Tuple[int, str, Any, Any, int,
                                               int]]) -> int:
        """Bulk ingest of ``(snapshot_id, vertex, key, value, pid,
        instance)`` tuples — the cross-process commit path: worker
        processes buffer their barrier-aligned state locally and ship it to
        the coordinator in one message per (worker, snapshot); the
        coordinator lands everything here before committing.  Returns the
        entry count.  Values are stored as handed over (no defensive copy):
        entries that crossed a process boundary were copied by pickling in
        transit, and the child-side buffer already took ownership."""
        n = 0
        imaps: Dict[int, IMap] = {}
        for snapshot_id, vertex, key, value, pid, instance in entries:
            imap = imaps.get(snapshot_id)
            if imap is None:
                imap = imaps[snapshot_id] = self.store._map(self.job_id,
                                                            snapshot_id)
            imap.put_with_pid((vertex, instance, key), value, pid)
            n += 1
        return n


class SnapshotStore:
    def __init__(self, service: IMapService):
        self.service = service
        # job -> latest committed snapshot id
        self.committed: Dict[str, int] = {}
        # job -> {snapshot_id: {"offsets": {...}}} (source replay positions)
        self.meta: Dict[str, Dict[int, Dict[str, Any]]] = {}

    def _map(self, job_id: str, snapshot_id: int) -> IMap:
        return IMap(self.service, f"__jet.snapshot.{job_id}.{snapshot_id}")

    def writer(self, job_id: str) -> SnapshotWriter:
        return SnapshotWriter(self, job_id)

    # -- lifecycle -------------------------------------------------------------
    def commit(self, job_id: str, snapshot_id: int) -> None:
        prev = self.committed.get(job_id)
        self.committed[job_id] = snapshot_id
        # retire the previous snapshot's storage (Jet keeps exactly one,
        # alternating between two map names; dropping the old one is the
        # equivalent here)
        if prev is not None and prev != snapshot_id:
            self._map(job_id, prev).destroy()

    def latest_committed(self, job_id: str) -> Optional[int]:
        return self.committed.get(job_id)

    # -- recovery-chain hooks (see module docstring) ---------------------------
    def recovery_chain(self, job_id: str) -> List[int]:
        """Candidate snapshot ids for recovery, newest first."""
        sid = self.committed.get(job_id)
        return [] if sid is None else [sid]

    def verify(self, job_id: str, snapshot_id: int) -> Tuple[bool, str]:
        """(ok, reason) — in-memory snapshots have nothing to verify."""
        return True, ""

    def prepare_restore(self, job_id: str,
                        snapshot_id: int) -> Tuple[bool, str]:
        """Materialize ``snapshot_id`` for ``entries_for_partition``;
        (ok, reason).  The in-memory store already holds it live."""
        return True, ""

    def discover_jobs(self) -> List[str]:
        """Job ids with at least one committed snapshot."""
        return sorted(self.committed)

    def set_meta(self, job_id: str, snapshot_id: int, key: str, value) -> None:
        self.meta.setdefault(job_id, {}).setdefault(snapshot_id, {})[key] = value

    def get_meta(self, job_id: str, snapshot_id: int, key: str, default=None):
        return self.meta.get(job_id, {}).get(snapshot_id, {}).get(key, default)

    # -- recovery ---------------------------------------------------------------
    def entries_for_partition(self, job_id: str, snapshot_id: int,
                              pid: int) -> List[Tuple[str, Any, Any]]:
        """[(vertex, key, value)] for one partition of a committed snapshot.
        Multiple entries may share (vertex, key) — one per instance that
        held a shard of that key's state."""
        imap = self._map(job_id, snapshot_id)
        return [(vertex, key, value)
                for (vertex, _inst, key), value
                in imap.entries_for_partition(pid).items()]

    def vertex_entries(self, job_id: str, snapshot_id: int,
                       vertex: str) -> List[Tuple[Any, Any]]:
        imap = self._map(job_id, snapshot_id)
        return [(key, value) for (v, _inst, key), value in imap.items().items()
                if v == vertex]

    def size(self, job_id: str, snapshot_id: int) -> int:
        return len(self._map(job_id, snapshot_id))
