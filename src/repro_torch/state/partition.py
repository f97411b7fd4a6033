"""Consistent-hash partition assignment (paper §4.3).

Partitions are assigned to members via a hash ring with virtual nodes
(Chord-style [Stoica et al.]): each member projects ``VNODES`` points onto
the ring; partition *p* lives on the first ``backup_count + 1`` distinct
members clockwise of ``hash(p)``.  Adding or removing one member therefore
moves only ~``1/n`` of the partitions — the "minimal migration" property the
paper leans on for elasticity.
"""

from __future__ import annotations

import hashlib
from bisect import bisect_right
from typing import Dict, List, Sequence, Tuple

VNODES = 64


def _hash64(data: str) -> int:
    return int.from_bytes(hashlib.blake2b(data.encode(), digest_size=8).digest(),
                          "big")


class PartitionTable:
    """partition id -> ordered replica list [primary, backup1, ...]."""

    def __init__(self, members: Sequence[int], partition_count: int = 271,
                 backup_count: int = 1):
        if not members:
            raise ValueError("need at least one member")
        self.partition_count = partition_count
        self.backup_count = backup_count
        self.members: List[int] = sorted(members)
        self.assignments: List[List[int]] = []
        self._rebuild()

    # -- ring ---------------------------------------------------------------
    def _ring(self) -> List[Tuple[int, int]]:
        pts = []
        for m in self.members:
            for v in range(VNODES):
                pts.append((_hash64(f"m{m}:v{v}"), m))
        pts.sort()
        return pts

    def _rebuild(self) -> None:
        ring = self._ring()
        hashes = [h for h, _ in ring]
        n_replicas = min(self.backup_count + 1, len(self.members))
        assignments = []
        for p in range(self.partition_count):
            h = _hash64(f"p{p}")
            idx = bisect_right(hashes, h) % len(ring)
            replicas: List[int] = []
            i = idx
            while len(replicas) < n_replicas:
                m = ring[i % len(ring)][1]
                if m not in replicas:
                    replicas.append(m)
                i += 1
            assignments.append(replicas)
        self.assignments = assignments

    # -- queries -------------------------------------------------------------
    def owner(self, pid: int) -> int:
        return self.assignments[pid][0]

    def replicas(self, pid: int) -> List[int]:
        return self.assignments[pid]

    def partitions_of(self, member: int, replica_index: int = 0) -> List[int]:
        return [p for p, reps in enumerate(self.assignments)
                if len(reps) > replica_index and reps[replica_index] == member]

    # -- membership changes ----------------------------------------------------
    def change_membership(self, members: Sequence[int]) -> Dict[int, Tuple[List[int], List[int]]]:
        """Recompute assignments for a new member list.

        Returns the migration plan: pid -> (old_replicas, new_replicas) for
        every partition whose replica list changed.
        """
        old = [list(r) for r in self.assignments]
        self.members = sorted(members)
        self._rebuild()
        plan = {}
        for p in range(self.partition_count):
            if old[p] != self.assignments[p]:
                plan[p] = (old[p], self.assignments[p])
        return plan
