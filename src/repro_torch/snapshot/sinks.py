"""Exactly-once delivery sinks (paper §4.5).

The snapshot protocol makes *state* effects exactly-once; making *output*
exactly-once needs the sink's cooperation:

* :class:`TransactionalSink` — two-phase commit: output buffers in a
  pending transaction per snapshot epoch; ``save_to_snapshot`` persists the
  pending buffer (commit-prepare), and the epoch is released to the
  external system only when the engine reports the snapshot committed.
  After a crash the restored pending buffer is re-committed — the external
  system sees each result exactly once (duplicates are fenced by the
  epoch id).
* :class:`IdempotentSink` — keyed writes: re-emission after replay
  overwrites the same key with the same value; the externally visible map
  converges to exactly the no-failure outcome.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.events import Event
from ..core.processor import Inbox, Processor


class ExternalCollector:
    """Stands in for the external system (e.g. a DB)."""

    def __init__(self):
        self.committed: List[Tuple[int, Any]] = []   # (epoch, value)
        self.kv: Dict[Any, Any] = {}
        self._epochs_seen: set = set()

    # transactional API
    def commit_epoch(self, epoch: int, items: List[Any]) -> None:
        if epoch in self._epochs_seen:     # fencing: re-commit is a no-op
            return
        self._epochs_seen.add(epoch)
        self.committed.extend((epoch, it) for it in items)

    # idempotent API
    def upsert(self, key, value) -> None:
        self.kv[key] = value


class TransactionalSink(Processor):
    """Buffers output per snapshot epoch; releases on snapshot commit.

    Transaction ids are STABLE across crashes — ``(snapshot_id, saver
    instance)`` is stored inside the snapshot itself — so a re-commit after
    restore is fenced by the external system exactly like a prepared XA
    transaction being re-committed."""

    #: pending IS snapshotted (under its stable txn id) but restores into
    #: ``prepared``: a restored buffer is by definition past its
    #: commit-prepare, so it re-enters phase 2, not the open epoch
    SNAPSHOT_STATE = frozenset({"pending"})

    def __init__(self, collector: ExternalCollector):
        self.collector = collector
        self.pending: List[Any] = []       # current (uncommitted) epoch
        # txn_id -> buffer, txn_id = (snapshot_id, saver_global_index)
        self.prepared: Dict[Any, List[Any]] = {}

    def process(self, ordinal: int, inbox: Inbox) -> None:
        while True:
            ev = inbox.poll()
            if ev is None:
                return
            self.pending.append(ev.value)

    # -- two-phase commit hooks --------------------------------------------------
    def save_to_snapshot(self) -> bool:
        # commit-prepare: the pending buffer (with its stable txn id)
        # rides in the snapshot; ``current_snapshot_id`` is set by the
        # tasklet before this hook runs
        sid = getattr(self, "current_snapshot_id", 0)
        txn = (sid, self.ctx.global_index)
        self.outbox.offer_to_snapshot(("txn", self.ctx.global_index),
                                      (txn, list(self.pending)))
        self.prepared[txn] = self.pending
        self.pending = []
        return True

    def on_snapshot_committed(self, snapshot_id: int) -> None:
        """Called by the engine when the snapshot commits (phase 2)."""
        for txn in sorted(self.prepared):
            self.collector.commit_epoch(txn, self.prepared[txn])
        self.prepared.clear()

    def restore_from_snapshot(self, items) -> None:
        # prepared-but-unreleased buffers re-commit after restart (phase 2
        # after crash); stable txn ids make double commits no-ops
        for (tag, _idx), (txn, buf) in items:
            if tag == "txn" and buf:
                self.prepared[tuple(txn)] = list(buf)

    def finish_snapshot_restore(self) -> None:
        self.on_snapshot_committed(-1)

    def complete(self) -> bool:
        # batch jobs: release whatever is pending at end-of-stream
        self.on_snapshot_committed(-1)
        if self.pending:
            self.collector.commit_epoch(
                ("final", self.ctx.global_index), self.pending)
            self.pending = []
        return True


class IdempotentSink(Processor):
    """Keyed upserts: replayed results overwrite identically."""

    def __init__(self, collector: ExternalCollector,
                 key_fn: Optional[Callable[[Event], Any]] = None):
        self.collector = collector
        self.key_fn = key_fn or (lambda ev: ev.key)

    def process(self, ordinal: int, inbox: Inbox) -> None:
        while True:
            ev = inbox.poll()
            if ev is None:
                return
            self.collector.upsert(self.key_fn(ev), ev.value)
