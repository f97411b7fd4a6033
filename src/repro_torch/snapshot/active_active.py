"""Active-active deployment (paper §4.6): run the job twice, one active
and one hot standby, and deduplicate outputs by record id — trading the
snapshot protocol's latency for 2x resources.

The two replicas are independent JetClusters fed by the same replayable
source; outputs merge through :class:`DedupingOutput`, which keeps the
first result per record id (results are deterministic, so either replica's
answer is THE answer).  On primary failure the standby simply keeps
emitting — zero recovery gap, no snapshot restore.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..core import JetCluster, JobConfig
from ..core.engine import JOB_COMPLETED


class DedupingOutput:
    """First-wins merge of the two replicas' outputs by record id."""

    def __init__(self, id_fn: Callable):
        self.id_fn = id_fn
        self.results: Dict = {}
        self.duplicates = 0

    def sink_for_replica(self, replica: int):
        def consume(ev):
            rid = self.id_fn(ev)
            if rid in self.results:
                self.duplicates += 1
            else:
                self.results[rid] = (replica, ev)
        return consume


class ActiveActiveRunner:
    def __init__(self, build_pipeline: Callable[[Callable], object],
                 id_fn: Callable, n_nodes: int = 2,
                 cooperative_threads: int = 2, clock_factory=None):
        """``build_pipeline(sink_consumer) -> Pipeline``."""
        self.output = DedupingOutput(id_fn)
        self.clusters: List[JetCluster] = []
        self.jobs = []
        for replica in range(2):
            clock = clock_factory() if clock_factory else None
            cluster = JetCluster(n_nodes=n_nodes,
                                 cooperative_threads=cooperative_threads,
                                 clock=clock)
            p = build_pipeline(self.output.sink_for_replica(replica))
            # §4.6: no snapshot bookkeeping at all in active-active mode
            job = cluster.submit(p.to_dag(), JobConfig())
            self.clusters.append(cluster)
            self.jobs.append(job)
        self.failed: Optional[int] = None

    def step(self) -> None:
        for i, cluster in enumerate(self.clusters):
            if self.failed == i:
                continue
            cluster.step()

    def kill_replica(self, replica: int) -> None:
        """Simulate a whole-replica loss: the other keeps serving."""
        self.failed = replica

    def run_until_complete(self, max_steps: int = 2_000_000) -> None:
        for _ in range(max_steps):
            done = [j.status == JOB_COMPLETED
                    for i, j in enumerate(self.jobs) if i != self.failed]
            if done and all(done):
                return
            self.step()
        raise TimeoutError("active-active run did not complete")
