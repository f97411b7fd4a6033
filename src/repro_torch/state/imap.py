"""Partitioned, replicated, in-memory maps — the Jet state backend (§4.2).

:class:`IMapService` models the IMDG member stores of a cluster: every
member holds the *primary* copy of the partitions it owns plus *backup*
copies of partitions owned by others, per the :class:`PartitionTable`.
Writes go to the primary and replicate synchronously to the backups
(Hazelcast's default ``backup-count=1`` sync semantics).

Failure handling mirrors Figure 6 of the paper: when a member dies, each of
its partitions is *promoted* on the surviving member that held the first
backup copy, and fresh backups are re-materialized on other members.  Data
is lost only if every replica of a partition dies inside one failure event.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from .partition import PartitionTable

# store key: (map_name, partition_id) -> {key: value}
_Store = Dict[Tuple[str, int], Dict[Any, Any]]


class IMapService:
    def __init__(self, members: Iterable[int], partition_count: int = 271,
                 backup_count: int = 1):
        self.table = PartitionTable(list(members), partition_count,
                                    backup_count)
        self.partition_count = partition_count
        self.stores: Dict[int, _Store] = {m: {} for m in self.table.members}
        # telemetry
        self.migrated_partitions = 0
        self.promoted_partitions = 0

    # -- data plane --------------------------------------------------------------
    def write(self, map_name: str, pid: int, key, value) -> None:
        for member in self.table.replicas(pid):
            self.stores[member].setdefault((map_name, pid), {})[key] = value

    def read(self, map_name: str, pid: int, key, default=None):
        owner = self.table.owner(pid)
        return self.stores[owner].get((map_name, pid), {}).get(key, default)

    def remove(self, map_name: str, pid: int, key) -> None:
        for member in self.table.replicas(pid):
            part = self.stores[member].get((map_name, pid))
            if part is not None:
                part.pop(key, None)

    def entries(self, map_name: str, pid: int) -> Dict[Any, Any]:
        owner = self.table.owner(pid)
        return dict(self.stores[owner].get((map_name, pid), {}))

    def all_entries(self, map_name: str) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        for pid in range(self.partition_count):
            out.update(self.entries(map_name, pid))
        return out

    def drop_map(self, map_name: str) -> None:
        for store in self.stores.values():
            for k in [k for k in store if k[0] == map_name]:
                del store[k]

    def map_names(self) -> Set[str]:
        return {name for store in self.stores.values() for (name, _) in store}

    # -- membership / failover -----------------------------------------------------
    def kill_member(self, member: int) -> List[int]:
        """Remove a member; promote backups (Fig. 6). Returns the list of
        partitions whose data was lost entirely (all replicas on the dead
        member — only possible with backup_count == 0)."""
        if member not in self.stores:
            raise KeyError(f"member {member} not in cluster")
        dead_store = self.stores.pop(member)
        survivors = [m for m in self.table.members if m != member]
        lost: List[int] = []
        # partitions that had a replica on the dead member
        affected = [p for p in range(self.partition_count)
                    if member in self.table.replicas(p)]
        was_primary = {p for p in affected if self.table.owner(p) == member}
        plan = self.table.change_membership(survivors)
        # ensure every replica in the new table has the data
        for pid in range(self.partition_count):
            new_reps = self.table.replicas(pid)
            # find any survivor holding this partition's maps (old replica)
            source: Optional[int] = None
            for m in self.stores:
                if any(k[1] == pid for k in self.stores[m]):
                    source = m
                    break
            if source is None:
                if any(k[1] == pid for k in dead_store):
                    lost.append(pid)
                continue
            src_maps = {k: dict(v) for k, v in self.stores[source].items()
                        if k[1] == pid}
            for m in new_reps:
                for k, data in src_maps.items():
                    dst = self.stores[m].setdefault(k, {})
                    for kk, vv in data.items():
                        dst.setdefault(kk, vv)
            if pid in was_primary:
                self.promoted_partitions += 1
        # drop copies on members that are no longer replicas
        self._garbage_collect()
        return lost

    def add_member(self, member: int) -> int:
        """Join a member and rebalance; returns number of migrated
        partitions (tests assert ~1/n, the consistent-hashing property)."""
        if member in self.stores:
            raise KeyError(f"member {member} already in cluster")
        self.stores[member] = {}
        plan = self.table.change_membership(
            list(self.table.members) + [member])
        moved = 0
        for pid, (old_reps, new_reps) in plan.items():
            src = next((m for m in old_reps if m in self.stores
                        and m not in (member,)), None)
            if src is None:
                continue
            src_maps = {k: dict(v) for k, v in self.stores[src].items()
                        if k[1] == pid}
            for m in new_reps:
                if m == src:
                    continue
                for k, data in src_maps.items():
                    dst = self.stores[m].setdefault(k, {})
                    for kk, vv in data.items():
                        dst.setdefault(kk, vv)
            moved += 1
        self.migrated_partitions += moved
        self._garbage_collect()
        return moved

    def _garbage_collect(self) -> None:
        for m, store in self.stores.items():
            stale = [k for k in store if m not in self.table.replicas(k[1])]
            for k in stale:
                del store[k]

    # -- introspection ---------------------------------------------------------
    def bytes_estimate(self) -> int:
        import sys
        return sum(sys.getsizeof(v) for store in self.stores.values()
                   for part in store.values() for v in part.values())


class IMap:
    """A named, partitioned, replicated key-value map (the public face)."""

    def __init__(self, service: IMapService, name: str):
        self.service = service
        self.name = name

    def _pid(self, key) -> int:
        return hash(key) % self.service.partition_count

    def put(self, key, value) -> None:
        self.service.write(self.name, self._pid(key), key, value)

    def put_with_pid(self, key, value, pid: int) -> None:
        """Write under an explicit partition (snapshot routing)."""
        self.service.write(self.name, pid, key, value)

    def get(self, key, default=None):
        return self.service.read(self.name, self._pid(key), key, default)

    def remove(self, key) -> None:
        self.service.remove(self.name, self._pid(key), key)

    def entries_for_partition(self, pid: int) -> Dict[Any, Any]:
        return self.service.entries(self.name, pid)

    def items(self) -> Dict[Any, Any]:
        return self.service.all_entries(self.name)

    def __len__(self) -> int:
        return len(self.items())

    def destroy(self) -> None:
        self.service.drop_map(self.name)
