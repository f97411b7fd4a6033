"""Jet core: DAG execution engine with tasklets, cooperative scheduling,
watermarks, windows, Chandy-Lamport snapshots and backpressure.

Copies of ``repro/core/*`` (the host engine is plain Python and numpy),
but for ``device_window.py``, the port's own bridge onto
``repro_torch.streaming``: ``Pipeline.window(w).aggregate(op,
placement="device")`` lowers onto it.  ``backend="mp"`` runs one OS
process a (node, cooperative thread) over ``core/shm_ring.py``'s rings
(``runtime/worker_proc.py``) and refuses device vertices, as the
reference does."""

from .backend import (ExecutionBackend, InProcessBackend, WorkerFailure,
                      make_backend)
from .clock import Clock, VirtualClock, WallClock
from .dag import DAG, Edge, PARTITION_COUNT, Routing, Vertex
from .device_window import DeviceWindowProcessor
from .engine import (JetCluster, Job, JobConfig, JobFailedError,
                     RestartPolicy, JOB_COMPLETED, JOB_FAILED, JOB_RUNNING)
from .events import (Barrier, DONE, Event, EventBlock, LateEvent, Watermark,
                     block_form)
from .pipeline import Pipeline, group_aggregate
from .processor import (FilterProcessor, FlatMapProcessor,
                        FusedFunctionProcessor, Inbox, MapProcessor, Outbox,
                        Processor, SinkProcessor)
from .sources import (CollectorSink, Journal, JournalSource, ListSource,
                      PacedGeneratorSource)
from .tasklet import (GUARANTEE_AT_LEAST_ONCE, GUARANTEE_EXACTLY_ONCE,
                      GUARANTEE_NONE)
from .watermark import EventTimePolicy, WatermarkCoalescer
from .window import (AggregateOperation, SessionResult, SessionWindowDef,
                     SessionWindowProcessor, WindowResult, averaging,
                     co_aggregate, counting, max_by, session, sliding,
                     summing, to_list, tumbling)

__all__ = [
    "ExecutionBackend", "InProcessBackend", "WorkerFailure", "make_backend",
    "Clock", "VirtualClock", "WallClock",
    "DAG", "Edge", "PARTITION_COUNT", "Routing", "Vertex",
    "DeviceWindowProcessor",
    "JetCluster", "Job", "JobConfig", "JobFailedError", "RestartPolicy",
    "JOB_COMPLETED", "JOB_FAILED", "JOB_RUNNING",
    "Barrier", "DONE", "Event", "EventBlock", "LateEvent", "Watermark",
    "block_form",
    "Pipeline", "group_aggregate",
    "FilterProcessor", "FlatMapProcessor", "FusedFunctionProcessor",
    "Inbox", "MapProcessor", "Outbox", "Processor", "SinkProcessor",
    "CollectorSink", "Journal", "JournalSource", "ListSource",
    "PacedGeneratorSource",
    "GUARANTEE_AT_LEAST_ONCE", "GUARANTEE_EXACTLY_ONCE", "GUARANTEE_NONE",
    "EventTimePolicy", "WatermarkCoalescer",
    "AggregateOperation", "SessionResult", "SessionWindowDef",
    "SessionWindowProcessor", "WindowResult", "averaging", "co_aggregate",
    "counting", "max_by", "session", "sliding", "summing", "to_list",
    "tumbling",
]
