"""Core DAG: vertices, edges, routing policies.

Mirrors Jet's Core API (`com.hazelcast.jet.core.DAG`): a vertex names a
processor supplier and a local parallelism; an edge carries a routing policy
(isolated / round-robin / partitioned / broadcast), a locality (local vs
distributed) and a bounded queue size.  The planner in ``pipeline.py``
lowers the fluent Pipeline API onto this representation; the engine in
``engine.py`` instantiates it as tasklets.
"""

from __future__ import annotations

import graphlib
from typing import Callable, Dict, List, Optional

import numpy as np

DEFAULT_QUEUE_SIZE = 1024
#: Number of key partitions in the cluster; Hazelcast's default is 271.
PARTITION_COUNT = 271

#: CPython's hash modulus for int (sys.hash_info.modulus, 2**61 - 1)
_PYHASH_MODULUS = (1 << 61) - 1


def partition_for_key(key, partition_count: int = PARTITION_COUNT) -> int:
    """Key -> partition id.  Stable across the cluster (and across tiers:
    the device tier uses the same function vectorized)."""
    return hash(key) % partition_count


def partitions_for_keys(keys, partition_count: int = PARTITION_COUNT):
    """Vectorized :func:`partition_for_key` over an int64 key column.

    Bit-identical to ``hash(int(k)) % partition_count`` for every int64
    key (CPython int hash is the value mod 2**61-1, sign-preserving, with
    -1 mapped to -2; Python ``%`` then yields the non-negative residue).
    """
    k = np.asarray(keys, dtype=np.int64)
    h = k % _PYHASH_MODULUS
    neg = k < 0
    if neg.any():
        # hash(-n) == -hash(n); int64 min would overflow on negation, but
        # its hash is the constant -(2**63 % modulus) == -4
        imin = k == np.iinfo(np.int64).min
        safe = np.nonzero(neg & ~imin)[0]
        h[safe] = -((-k[safe]) % _PYHASH_MODULUS)
        h[imin] = -4
        h[h == -1] = -2
    return h % partition_count


class Routing:
    ISOLATED = "isolated"        # 1:1 between parallel instances
    ROUND_ROBIN = "round_robin"  # load-balance across consumers
    PARTITIONED = "partitioned"  # by key partition (two-stage aggregation)
    BROADCAST = "broadcast"      # every consumer gets every item


class Vertex:
    def __init__(self, name: str, supplier: Callable[[], "Processor"],
                 local_parallelism: int = -1):
        self.name = name
        self.supplier = supplier
        #: -1 = use the node's cooperative thread count (whole-DAG-per-core)
        self.local_parallelism = local_parallelism

    def __repr__(self):  # pragma: no cover
        return f"Vertex({self.name!r}, lp={self.local_parallelism})"


class Edge:
    def __init__(self, src: str, dst: str, *, src_ordinal: int = 0,
                 dst_ordinal: int = 0, routing: str = Routing.ROUND_ROBIN,
                 distributed: bool = False,
                 key_fn: Optional[Callable] = None,
                 queue_size: int = DEFAULT_QUEUE_SIZE,
                 priority: int = 0):
        self.src = src
        self.dst = dst
        self.src_ordinal = src_ordinal
        self.dst_ordinal = dst_ordinal
        self.routing = routing
        #: distributed edges cross node boundaries through exchange tasklets
        self.distributed = distributed
        #: key extractor for PARTITIONED routing (defaults to Event.key)
        self.key_fn = key_fn
        self.queue_size = queue_size
        #: lower value = consumed first (Jet uses priorities for hash-join
        #: build sides: the batch side drains fully before the probe side)
        self.priority = priority

    def partitioned(self, key_fn: Optional[Callable] = None) -> "Edge":
        self.routing = Routing.PARTITIONED
        self.key_fn = key_fn
        return self

    def all_to_one(self) -> "Edge":
        """Route everything to a single processor instance (global stage)."""
        self.routing = Routing.PARTITIONED
        self.key_fn = lambda ev: 0
        return self

    def broadcast(self) -> "Edge":
        self.routing = Routing.BROADCAST
        return self

    def isolated(self) -> "Edge":
        self.routing = Routing.ISOLATED
        return self

    def set_distributed(self, flag: bool = True) -> "Edge":
        self.distributed = flag
        return self

    def __repr__(self):  # pragma: no cover
        loc = "dist" if self.distributed else "local"
        return (f"Edge({self.src}:{self.src_ordinal} -> "
                f"{self.dst}:{self.dst_ordinal}, {self.routing}, {loc})")


class DAG:
    def __init__(self):
        self.vertices: Dict[str, Vertex] = {}
        self.edges: List[Edge] = []

    def vertex(self, name: str, supplier, local_parallelism: int = -1) -> Vertex:
        if name in self.vertices:
            raise ValueError(f"duplicate vertex {name!r}")
        v = Vertex(name, supplier, local_parallelism)
        self.vertices[name] = v
        return v

    def edge(self, edge: Edge) -> Edge:
        if edge.src not in self.vertices or edge.dst not in self.vertices:
            raise ValueError(f"edge references unknown vertex: {edge}")
        for e in self.edges:
            if (e.src, e.src_ordinal) == (edge.src, edge.src_ordinal):
                raise ValueError(
                    f"source ordinal {edge.src}:{edge.src_ordinal} already used")
            if (e.dst, e.dst_ordinal) == (edge.dst, edge.dst_ordinal):
                raise ValueError(
                    f"dest ordinal {edge.dst}:{edge.dst_ordinal} already used")
        self.edges.append(edge)
        return edge

    # -- structure queries ---------------------------------------------------
    def in_edges(self, name: str) -> List[Edge]:
        return sorted((e for e in self.edges if e.dst == name),
                      key=lambda e: (e.priority, e.dst_ordinal))

    def out_edges(self, name: str) -> List[Edge]:
        return sorted((e for e in self.edges if e.src == name),
                      key=lambda e: e.src_ordinal)

    def sources(self) -> List[str]:
        return [n for n in self.vertices if not self.in_edges(n)]

    def sinks(self) -> List[str]:
        return [n for n in self.vertices if not self.out_edges(n)]

    def topological_order(self) -> List[str]:
        """Vertex names in topological order; raises on cycles."""
        ts = graphlib.TopologicalSorter(
            {n: [e.src for e in self.in_edges(n)] for n in self.vertices})
        return list(ts.static_order())

    def validate(self) -> None:
        self.topological_order()  # raises CycleError on a cycle
        if not self.vertices:
            raise ValueError("empty DAG")
