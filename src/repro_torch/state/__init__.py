"""IMDG-style state backend: consistent-hash partitioning, replicated
in-memory maps, snapshot store, failover and rebalancing (paper §4)."""

from .partition import PartitionTable
from .imap import IMapService, IMap
from .snapshot_store import SnapshotStore
from .durable_store import DurableSnapshotStore

__all__ = ["PartitionTable", "IMapService", "IMap", "SnapshotStore",
           "DurableSnapshotStore"]
