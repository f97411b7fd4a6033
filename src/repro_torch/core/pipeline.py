"""The Pipeline API: fluent, composable stage graph that the planner lowers
onto the Core DAG (paper §2.1–2.2, Listing 1/2).

The planner performs Jet's two signature optimizations:

* **operator fusion** — maximal chains of stateless stages (map / filter /
  flat_map / re-key) with a single consumer collapse into ONE vertex running
  a :class:`FusedFunctionProcessor` (one Python call per event for the whole
  chain), connected by ISOLATED edges so data stays on its core;
* **two-stage aggregation** — ``window().aggregate()`` lowers into a *local*
  partitioned accumulate vertex followed by a *distributed* partitioned
  combine vertex, so only closed frames travel across nodes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .dag import DAG, Edge, Routing
from .events import Event, EventBlock, LateEvent
from .processor import (FusedFunctionProcessor, Inbox, Processor,
                        SinkProcessor)
from .window import (AccumulateByFrameProcessor, AggregateOperation,
                     CombineFramesProcessor, SessionWindowDef,
                     SessionWindowProcessor, SlidingWindowDef)


# ---------------------------------------------------------------------------
# Logical stages
# ---------------------------------------------------------------------------


class _Stage:
    def __init__(self, pipeline: "Pipeline", kind: str, name: str,
                 upstreams: List["_Stage"], params: Dict[str, Any]):
        self.pipeline = pipeline
        self.kind = kind
        # numbered within its pipeline (the reference counts across the
        # process): a pipeline rebuilt the same way gets the same vertex
        # names, which is what a restore from a durable chain matches
        # its entries by (JetCluster.recover_job)
        self.name = f"{name}-{len(pipeline.stages)}"
        self.upstreams = upstreams
        self.params = params
        self.downstream_count = 0
        for up in upstreams:
            up.downstream_count += 1
        pipeline.stages.append(self)


class GeneralStage:
    """User-facing handle over a logical stage."""

    def __init__(self, pipeline: "Pipeline", stage: _Stage):
        self.pipeline = pipeline
        self.stage = stage

    # -- stateless transforms (fusable) -----------------------------------------
    def map(self, fn: Callable[[Any], Any]) -> "GeneralStage":
        return self._compute("map", fn)

    def filter(self, pred: Callable[[Any], bool]) -> "GeneralStage":
        return self._compute("filter", pred)

    def flat_map(self, fn: Callable[[Any], Iterable[Any]]) -> "GeneralStage":
        return self._compute("flat_map", fn)

    def rekey(self, key_fn: Callable[[Any], Any]) -> "GeneralStage":
        """Assign the grouping key (Jet's groupingKey)."""
        return self._compute("rekey", key_fn)

    def _compute(self, op: str, fn) -> "GeneralStage":
        st = _Stage(self.pipeline, "compute", op, [self.stage],
                    {"op": op, "fn": fn})
        return GeneralStage(self.pipeline, st)

    # -- keyed / windowed ---------------------------------------------------------
    def with_key(self, key_fn: Callable[[Any], Any]) -> "KeyedStage":
        return KeyedStage(self.pipeline, self.rekey(key_fn).stage)

    # -- joins ----------------------------------------------------------------------
    def hash_join(self, build: "GeneralStage",
                  probe_key_fn: Callable[[Any], Any],
                  build_key_fn: Callable[[Any], Any],
                  combine_fn: Callable[[Any, Any], Any],
                  inner: bool = True) -> "GeneralStage":
        """Join this (probe, streaming) stage against a batch build stage
        (Listing 2).  The build side is broadcast and fully consumed before
        probing starts."""
        st = _Stage(self.pipeline, "hash_join", "hash_join",
                    [self.stage, build.stage],
                    {"probe_key_fn": probe_key_fn, "build_key_fn": build_key_fn,
                     "combine_fn": combine_fn, "inner": inner})
        return GeneralStage(self.pipeline, st)

    # -- sinks ----------------------------------------------------------------------
    def write_to(self, sink_supplier: Callable[[], Processor]) -> None:
        _Stage(self.pipeline, "sink", "sink", [self.stage],
               {"supplier": sink_supplier})

    def custom_transform(self, name: str,
                         supplier: Callable[[], Processor],
                         partitioned: bool = False,
                         distributed: bool = False) -> "GeneralStage":
        st = _Stage(self.pipeline, "custom", name, [self.stage],
                    {"supplier": supplier, "partitioned": partitioned,
                     "distributed": distributed})
        return GeneralStage(self.pipeline, st)


class KeyedStage(GeneralStage):
    """A stage with a grouping key assigned; adds windowing on top of the
    general transforms (a keyed custom_transform routes by the key)."""

    def window(self, wdef) -> "WindowedStage":
        """``wdef``: a :class:`SlidingWindowDef` or :class:`SessionWindowDef`."""
        return WindowedStage(self.pipeline, self.stage, wdef)


class WindowedStage:
    def __init__(self, pipeline: "Pipeline", stage: _Stage, wdef):
        self.pipeline = pipeline
        self.stage = stage
        self.wdef = wdef
        self._lateness = 0
        self._late_sink: Optional[Callable[[], Processor]] = None

    def allowed_lateness(self, lateness: int) -> "WindowedStage":
        """Keep windows re-firable for ``lateness`` event-time past the
        watermark: admissible late events update already-emitted results;
        anything later is dropped (and counted / side-routed)."""
        if lateness < 0:
            raise ValueError("allowed_lateness must be >= 0")
        self._lateness = lateness
        return self

    def late_sink(self, sink_supplier: Callable[[], Processor]
                  ) -> "WindowedStage":
        """Route events later than the allowed lateness to this sink (as
        :class:`~repro_torch.core.events.LateEvent`) instead of dropping
        them."""
        self._late_sink = sink_supplier
        return self

    def aggregate(self, op: AggregateOperation, placement: str = "host",
                  device: Optional[Dict[str, Any]] = None) -> GeneralStage:
        """``placement="device"`` offloads the aggregation to the compiled
        device tier: ONE block-aware vertex drives a
        :class:`~repro_torch.core.device_window.DeviceWindowProcessor`
        (StreamExecutor step per padded batch) instead of the host
        two-stage accumulate/combine plan.  ``device`` forwards keyword
        overrides (``n_key_buckets``, ``batch_size``, ...) to the
        processor.  Sessions and allowed lateness stay host-only."""
        if placement == "device":
            if isinstance(self.wdef, SessionWindowDef):
                raise ValueError("session windows run on the host")
            if self._lateness or self._late_sink is not None:
                raise ValueError(
                    "allowed_lateness/late_sink are host-only features")
            st = _Stage(self.pipeline, "window_agg_device", "win_agg_dev",
                        [self.stage],
                        {"wdef": self.wdef, "op": op,
                         "device": device or {}})
            return GeneralStage(self.pipeline, st)
        if placement != "host":
            raise ValueError(f"unknown placement {placement!r}")
        st = _Stage(self.pipeline, "window_agg", "win_agg", [self.stage],
                    {"wdef": self.wdef, "op": op,
                     "lateness": self._lateness,
                     "late_sink": self._late_sink})
        return GeneralStage(self.pipeline, st)

    def aggregate2(self, other: KeyedStage,
                   op: AggregateOperation) -> GeneralStage:
        """Two-input windowed co-aggregation (windowed join substrate,
        NEXMark Q8)."""
        if isinstance(self.wdef, SessionWindowDef):
            raise ValueError("session windows are single-input")
        st = _Stage(self.pipeline, "window_agg2", "win_agg2",
                    [self.stage, other.stage],
                    {"wdef": self.wdef, "op": op,
                     "lateness": self._lateness,
                     "late_sink": self._late_sink})
        return GeneralStage(self.pipeline, st)


class Pipeline:
    def __init__(self):
        self.stages: List[_Stage] = []

    @staticmethod
    def create() -> "Pipeline":
        return Pipeline()

    def read_from(self, source_supplier: Callable[[], Processor],
                  name: str = "source",
                  local_parallelism: int = -1) -> GeneralStage:
        st = _Stage(self, "source", name, [],
                    {"supplier": source_supplier, "lp": local_parallelism})
        return GeneralStage(self, st)

    # ------------------------------------------------------------------ planner --
    def to_dag(self) -> DAG:
        return _Planner(self).plan()


# ---------------------------------------------------------------------------
# Source fusion: run a stateless chain at the source's own outbox
# ---------------------------------------------------------------------------


class _ChainOutbox:
    """Outbox facade that applies a fused stateless chain at emission time.

    Data events run through the chain before landing in the real outbox;
    control items (watermarks) pass straight through.  This is what lets
    the planner collapse ``source -> fused-chain`` into ONE vertex: the
    whole queue hop between them disappears.

    EventBlocks take the vectorized chain (``chain_blk``) when every step
    declared a block form; otherwise they explode here and run the scalar
    chain per event — the source boundary is where per-event semantics are
    restored for black-box chains.  Like the scalar fan-out case, an
    exploded block may overshoot the outbox batch limit (by up to the
    block size); the engine avoids the path entirely for auto-mode
    sources by downgrading them to scalar emission when their chain
    cannot vectorize (see ExecutionContext._build).
    """

    __slots__ = ("_target", "_chain", "_chain1", "_chain_blk")

    def __init__(self, target, chain, chain1=None, chain_blk=None):
        self._target = target
        self._chain = chain
        #: scalar in-place variant (Event -> Event | None); preferred when
        #: the chain has no flat_map — no per-event tuple/Event churn
        self._chain1 = chain1
        #: vectorized variant (EventBlock -> EventBlock | None)
        self._chain_blk = chain_blk

    def _chain_block(self, blk):
        """Block through the chain -> list of result items (0 or 1 block,
        or the exploded per-event results for a scalar-only chain)."""
        chain_blk = self._chain_blk
        if chain_blk is not None:
            out = chain_blk(blk)
            return () if out is None or not len(out) else (out,)
        chain1 = self._chain1
        if chain1 is not None:
            out = []
            append = out.append
            for ev in blk.to_events():
                ev = chain1(ev)
                if ev is not None:
                    append(ev)
            return out
        chain = self._chain
        out = []
        for ev in blk.to_events():
            out.extend(chain(ev))
        return out

    def offer(self, item) -> bool:
        t = self._target
        cls = item.__class__
        if cls is EventBlock:
            outs = self._chain_block(item)
            if not outs:
                return True
            if t.space() <= 0:
                return False
            t.extend(outs)
            return True
        if cls is Event or isinstance(item, Event):
            chain1 = self._chain1
            if chain1 is not None:
                ev = chain1(item)
                return True if ev is None else t.offer(ev)
            outs = self._chain(item)
            if not outs:
                return True         # filtered out: item is consumed
            if t.space() <= 0:
                return False
            t.extend(outs)          # may overshoot by the chain fan-out - 1
            return True
        return t.offer(item)

    def space(self) -> int:
        return self._target.space()

    def extend(self, items) -> None:
        chain1 = self._chain1
        out: List[Any] = []
        append = out.append
        extend = out.extend
        if chain1 is not None:
            for item in items:
                cls = item.__class__
                if cls is EventBlock:
                    extend(self._chain_block(item))
                elif cls is Event or isinstance(item, Event):
                    ev = chain1(item)
                    if ev is not None:
                        append(ev)
                else:
                    append(item)
        else:
            chain = self._chain
            for item in items:
                cls = item.__class__
                if cls is EventBlock:
                    extend(self._chain_block(item))
                elif cls is Event or isinstance(item, Event):
                    extend(chain(item))
                else:
                    append(item)
        self._target.extend(out)

    def offer_to_snapshot(self, key, value) -> bool:
        return self._target.offer_to_snapshot(key, value)

    @property
    def snapshot_queue(self):
        return self._target.snapshot_queue

    def drain(self):
        return self._target.drain()

    def __len__(self):
        return len(self._target)


class ChainedSourceProcessor(Processor):
    """Wraps a source processor so a fused stateless chain runs at its
    outbox (operator fusion extended through the source boundary, §3.1)."""

    def __init__(self, inner: Processor, chain, chain1=None, chain_blk=None):
        self.inner = inner
        self._chain = chain
        self._chain1 = chain1
        self._chain_blk = chain_blk
        self.is_cooperative = inner.is_cooperative
        # optional hooks the engine discovers via getattr
        if hasattr(inner, "snapshot_partition"):
            self.snapshot_partition = inner.snapshot_partition
        if hasattr(inner, "on_snapshot_committed"):
            self.on_snapshot_committed = inner.on_snapshot_committed

    def init(self, outbox, ctx) -> None:
        super().init(outbox, ctx)
        self.inner.init(_ChainOutbox(outbox, self._chain, self._chain1,
                                     self._chain_blk), ctx)

    def process(self, ordinal: int, inbox: Inbox) -> None:
        self.inner.process(ordinal, inbox)

    def try_process_watermark(self, wm) -> bool:
        return self.inner.try_process_watermark(wm)

    def complete_edge(self, ordinal: int) -> bool:
        return self.inner.complete_edge(ordinal)

    def complete(self) -> bool:
        return self.inner.complete()

    def save_to_snapshot(self) -> bool:
        return self.inner.save_to_snapshot()

    def restore_from_snapshot(self, items) -> None:
        self.inner.restore_from_snapshot(items)

    def finish_snapshot_restore(self) -> None:
        self.inner.finish_snapshot_restore()

    def close(self) -> None:
        self.inner.close()


# ---------------------------------------------------------------------------
# Late-event side output
# ---------------------------------------------------------------------------


class LateSplitProcessor(Processor):
    """Feeds only :class:`LateEvent` items to the wrapped sink processor.

    A window vertex with a late side output emits LateEvents interleaved
    with its regular output; the tasklet fan-out broadcasts every item to
    every out-edge, so each endpoint filters for its half: this wrapper on
    the late edge, the combiner / a drop-filter on the main edge.
    """

    #: _pending is pre-barrier input in flight: save_to_snapshot refuses
    #: to finish until _drain_pending() emptied it into the inner sink,
    #: so it is empty in every committed snapshot by construction
    EPHEMERAL_STATE = frozenset({"_pending"})

    def __init__(self, inner: Processor):
        self.inner = inner
        self.is_cooperative = inner.is_cooperative
        #: LateEvents the wrapped sink deferred under backpressure — kept
        #: (not dropped) per the processor contract and re-offered later
        self._pending = Inbox()
        # expose the inner sink's snapshot hooks (transactional/idempotent
        # late sinks), mirroring ChainedSourceProcessor
        if hasattr(inner, "snapshot_partition"):
            self.snapshot_partition = inner.snapshot_partition
        if hasattr(inner, "on_snapshot_committed"):
            self.on_snapshot_committed = inner.on_snapshot_committed

    def init(self, outbox, ctx) -> None:
        super().init(outbox, ctx)
        self.inner.init(outbox, ctx)

    def process(self, ordinal: int, inbox: Inbox) -> None:
        pend = self._pending
        for ev in inbox:
            if isinstance(ev, LateEvent):
                # jetlint: disable=hot-path-unbounded-growth -- the wrapped sink drains _pending on every process() call and before every barrier; it only holds one slice's deferred LateEvents
                pend.add(ev)
        inbox.clear()
        if len(pend):
            self.inner.process(ordinal, pend)

    def complete(self) -> bool:
        if not self._drain_pending():
            return False
        return self.inner.complete()

    def _drain_pending(self) -> bool:
        if len(self._pending):
            self.inner.process(0, self._pending)
        return not len(self._pending)

    # -- snapshots: deferred LateEvents are pre-barrier input and must be
    # consumed (or the save retried) before the barrier, else a restore
    # loses them — replay resumes after the barrier and never re-delivers
    def save_to_snapshot(self) -> bool:
        if not self._drain_pending():
            return False
        return self.inner.save_to_snapshot()

    def restore_from_snapshot(self, items) -> None:
        self.inner.restore_from_snapshot(items)

    def finish_snapshot_restore(self) -> None:
        self.inner.finish_snapshot_restore()

    def close(self) -> None:
        self.inner.close()


def _drop_late_chain(ev):
    """Fused-chain step: drop LateEvents on the main output path."""
    return () if isinstance(ev, LateEvent) else (ev,)


# ---------------------------------------------------------------------------
# Join / batch-aggregate processors used by the planner
# ---------------------------------------------------------------------------


class HashJoinProcessor(Processor):
    """Ordinal 1 = build (batch, priority 0), ordinal 0 = probe."""

    #: edge-exhaustion flag; a restored job replays the (batch) build
    #: edge from its source and re-derives it — only ``table`` is state
    EPHEMERAL_STATE = frozenset({"build_done"})

    def __init__(self, probe_key_fn, build_key_fn, combine_fn, inner=True):
        self.probe_key_fn = probe_key_fn
        self.build_key_fn = build_key_fn
        self.combine_fn = combine_fn
        self.inner = inner
        self.table: Dict[Any, Any] = {}
        self.build_done = False

    def process(self, ordinal: int, inbox: Inbox) -> None:
        if ordinal == 1:
            while True:
                ev = inbox.poll()
                if ev is None:
                    return
                self.table[self.build_key_fn(ev.value)] = ev.value
            return
        offer = self.outbox.offer
        while True:
            ev = inbox.peek()
            if ev is None:
                return
            k = self.probe_key_fn(ev.value)
            match = self.table.get(k)
            if match is not None or not self.inner:
                if not offer(ev.with_value((ev.value, match))):
                    return
            inbox.remove()

    def complete_edge(self, ordinal: int) -> bool:
        if ordinal == 1:
            self.build_done = True
        return True

    def save_to_snapshot(self) -> bool:
        for k, v in self.table.items():
            self.outbox.offer_to_snapshot(("ht", k), v)
        return True

    def restore_from_snapshot(self, items) -> None:
        for (tag, k), v in items:
            if tag == "ht":
                self.table[k] = v


class GroupAggregateProcessor(Processor):
    """Batch keyed aggregation: accumulate everything, emit on complete."""

    #: _emit is the complete()-phase emission stage, rebuilt from the
    #: snapshotted ``accs`` on replay (complete() re-runs after restore)
    EPHEMERAL_STATE = frozenset({"_emit"})

    def __init__(self, op: AggregateOperation):
        self.op = op
        self.accs: Dict[Any, Any] = {}
        self._emit: Optional[List] = None

    def process(self, ordinal: int, inbox: Inbox) -> None:
        op, accs = self.op, self.accs
        acc_fn = op.accumulate_fns[min(ordinal, len(op.accumulate_fns) - 1)]
        while True:
            ev = inbox.poll()
            if ev is None:
                return
            acc = accs.get(ev.key)
            if acc is None:
                acc = op.create()
            accs[ev.key] = acc_fn(acc, ev)

    def complete(self) -> bool:
        if self._emit is None:
            self._emit = [Event(0, k, self.op.export(a))
                          for k, a in self.accs.items()]
        while self._emit:
            if not self.outbox.offer(self._emit[-1]):
                return False
            self._emit.pop()
        return True

    def save_to_snapshot(self) -> bool:
        for k, acc in self.accs.items():
            self.outbox.offer_to_snapshot(("acc", k), acc)
        return True

    def restore_from_snapshot(self, items) -> None:
        for (tag, k), acc in items:
            if tag == "acc":
                cur = self.accs.get(k)
                self.accs[k] = acc if cur is None else self.op.combine(cur, acc)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


#: scalar-op dispatch codes shared by both chain compilers
_MAP, _FILTER, _REKEY = 0, 1, 2
_SCALAR_KINDS = {"map": _MAP, "filter": _FILTER, "rekey": _REKEY}


def _scalar_steps(ops: List[Tuple[str, Callable]]):
    """(kind, fn) steps for an all-scalar chain (every stage yields 0 or 1
    events), or None if any stage can fan out (flat_map)."""
    if not all(op in _SCALAR_KINDS for op, _ in ops):
        return None
    return tuple((_SCALAR_KINDS[op], fn) for op, fn in ops)


def _compile_chain_inplace(ops: List[Tuple[str, Callable]]):
    """Scalar-chain variant that mutates the event in place.

    Only safe where the caller OWNS the event — i.e. source fusion, where
    the event was just created by the source and has not entered any queue
    yet.  Returns None for non-scalar chains (flat_map)."""
    scalar = _scalar_steps(ops)
    if scalar is None:
        return None

    def chain_inplace(ev, _steps=scalar):
        """Event -> Event | None (no per-event tuple)."""
        for kind, f in _steps:
            if kind == 1:
                if not f(ev.value):
                    return None
            elif kind == 0:
                ev.value = f(ev.value)
            else:
                ev.key = f(ev.value)
        return ev

    return chain_inplace


def _compile_chain_block(ops: List[Tuple[str, Callable]]):
    """Vectorized chain variant: EventBlock -> EventBlock | None.

    Compiles only when the chain is all-scalar (no flat_map) AND every
    stage function carries a block form (see
    :func:`~repro_torch.core.events.block_form`); otherwise returns None and
    blocks explode to events at the chain boundary.
    """
    scalar = _scalar_steps(ops)
    if scalar is None:
        return None
    if not all(hasattr(fn, "__block_form__") for _, fn in ops):
        return None
    steps = tuple((kind, fn.__block_form__)
                  for (kind, _), (_, fn) in zip(scalar, ops))

    def chain_block(blk, _steps=steps):
        """EventBlock -> EventBlock | None (None == fully filtered)."""
        for kind, f in _steps:
            if kind == 1:
                mask = f(blk)
                if not mask.all():
                    blk = blk.compress(mask)
                    if not len(blk):
                        return None
            elif kind == 0:
                blk = blk.with_value_col(f(blk))
            else:
                blk = blk.with_key_col(f(blk))
        return blk

    return chain_block


def _compile_chain(ops: List[Tuple[str, Callable]]):
    """Compose a fused op chain into one Event -> tuple(Event) closure."""
    steps = []
    for op, fn in ops:
        if op == "map":
            steps.append(lambda ev, f=fn: (ev.with_value(f(ev.value)),))
        elif op == "filter":
            steps.append(lambda ev, f=fn: (ev,) if f(ev.value) else ())
        elif op == "flat_map":
            steps.append(lambda ev, f=fn: tuple(
                ev.with_value(v) for v in f(ev.value)))
        elif op == "rekey":
            steps.append(lambda ev, f=fn: (ev.with_key(f(ev.value)),))
        else:  # pragma: no cover
            raise ValueError(op)
    if len(steps) == 1:
        return steps[0]

    scalar = _scalar_steps(ops)
    if scalar is not None:
        # scalar chain: every stage yields 0 or 1 events, so the whole
        # chain runs as a straight-line loop over the event — no per-stage
        # tuple/list churn (this is the shape the fusion planner produces
        # for nearly every stateless pipeline segment)

        def chain_scalar(ev, _steps=scalar):
            for kind, f in _steps:
                if kind == 1:
                    if not f(ev.value):
                        return ()
                elif kind == 0:
                    ev = ev.with_value(f(ev.value))
                else:
                    ev = ev.with_key(f(ev.value))
            return (ev,)

        return chain_scalar

    def chain(ev, _steps=tuple(steps)):
        evs = (ev,)
        for s in _steps:
            out: List[Event] = []
            for e in evs:
                out.extend(s(e))
            if not out:
                return ()
            evs = out
        return tuple(evs)

    return chain


class _Planner:
    def __init__(self, pipeline: Pipeline):
        self.p = pipeline
        self.dag = DAG()
        #: logical stage -> (dag vertex name, preferred out-routing hints)
        self.vertex_of: Dict[_Stage, str] = {}
        self._out_ordinals: Dict[str, int] = {}

    def plan(self) -> DAG:
        consumed: set = set()
        for st in self.p.stages:
            if st in consumed:
                continue
            if st.kind == "source":
                self.dag.vertex(st.name, st.params["supplier"],
                                st.params.get("lp", -1))
                self.vertex_of[st] = st.name
            elif st.kind == "compute":
                chain, last = self._collect_chain(st, consumed)
                fused = _compile_chain([(s.params["op"], s.params["fn"])
                                        for s in chain])
                up = chain[0].upstreams[0]
                chain_ops = [(s.params["op"], s.params["fn"]) for s in chain]
                blocked = _compile_chain_block(chain_ops)
                if up.kind == "source" and up.downstream_count == 1:
                    # source fusion: the chain runs inside the source
                    # vertex itself — no intermediate vertex, no queue hop.
                    # The source owns each event until it enters a queue,
                    # so a scalar chain may rewrite it in place.
                    inplace = _compile_chain_inplace(chain_ops)
                    src_name = self.vertex_of[up]
                    vertex = self.dag.vertices[src_name]
                    supplier = vertex.supplier
                    vertex.supplier = (
                        lambda s=supplier, c=fused, c1=inplace, cb=blocked:
                        ChainedSourceProcessor(s(), c, c1, cb))
                    # rename so telemetry (straggler reports) attributes
                    # the chain's cost to it; no edges reference the
                    # source yet, so only the vertex table changes
                    new_name = f"{src_name}+{last.name}"
                    vertex.name = new_name
                    self.dag.vertices = {
                        (new_name if k == src_name else k): v
                        for k, v in self.dag.vertices.items()}
                    self.vertex_of[up] = new_name
                    for s in chain:
                        self.vertex_of[s] = new_name
                    continue
                name = last.name
                self.dag.vertex(
                    name, (lambda c=fused, cb=blocked:
                           FusedFunctionProcessor(c, cb)))
                self.vertex_of[last] = name
                for s in chain:
                    self.vertex_of[s] = name
                self._connect(up, name,
                              Edge(self._vname(up), name,
                                   routing=Routing.ISOLATED))
            elif st.kind in ("window_agg", "window_agg2"):
                self._plan_window_agg(st)
            elif st.kind == "window_agg_device":
                self._plan_window_agg_device(st)
            elif st.kind == "hash_join":
                self._plan_hash_join(st)
            elif st.kind == "sink":
                self.dag.vertex(st.name, st.params["supplier"])
                self.vertex_of[st] = st.name
                self._connect(st.upstreams[0], st.name,
                              Edge(self._vname(st.upstreams[0]), st.name,
                                   routing=Routing.ISOLATED))
            elif st.kind == "custom":
                self.dag.vertex(st.name, st.params["supplier"])
                self.vertex_of[st] = st.name
                routing = (Routing.PARTITIONED if st.params["partitioned"]
                           else Routing.ISOLATED)
                e = Edge(self._vname(st.upstreams[0]), st.name, routing=routing,
                         distributed=st.params["distributed"])
                self._connect(st.upstreams[0], st.name, e)
            elif st.kind == "custom2":
                # keyed two-input processor (incremental joins): both sides
                # partition+distribute so equal keys colocate
                self.dag.vertex(st.name, st.params["supplier"])
                self.vertex_of[st] = st.name
                for i, up in enumerate(st.upstreams):
                    e = Edge(self._vname(up), st.name, dst_ordinal=i,
                             routing=Routing.PARTITIONED, distributed=True)
                    self._connect_up(up, e)
            else:  # pragma: no cover
                raise ValueError(st.kind)
        self.dag.validate()
        return self.dag

    # -- helpers -------------------------------------------------------------
    def _vname(self, stage: _Stage) -> str:
        return self.vertex_of[stage]

    def _collect_chain(self, st: _Stage, consumed: set):
        """Greedy maximal fusion of a stateless chain starting at ``st``."""
        chain = [st]
        consumed.add(st)
        idx = self.p.stages.index(st)
        cur = st
        for nxt in self.p.stages[idx + 1:]:
            if (nxt.kind == "compute" and nxt.upstreams == [cur]
                    and cur.downstream_count == 1):
                chain.append(nxt)
                consumed.add(nxt)
                cur = nxt
            elif nxt.upstreams and cur in nxt.upstreams:
                break
        return chain, cur

    def _next_ordinal(self, vertex: str, side: str) -> int:
        key = f"{side}:{vertex}"
        n = self._out_ordinals.get(key, 0)
        self._out_ordinals[key] = n + 1
        return n

    def _connect(self, up_stage: _Stage, dst: str, edge: Edge) -> None:
        src = self._vname(up_stage)
        edge.src_ordinal = self._next_ordinal(src, "out")
        if edge.dst_ordinal == 0:
            edge.dst_ordinal = self._next_ordinal(dst, "in")
        self.dag.edge(edge)

    def _plan_window_agg(self, st: _Stage) -> None:
        wdef = st.params["wdef"]
        op: AggregateOperation = st.params["op"]
        lateness: int = st.params.get("lateness", 0)
        late_sink = st.params.get("late_sink")
        if isinstance(wdef, SessionWindowDef):
            self._plan_session_agg(st, wdef, op, lateness, late_sink)
            return
        two_input = st.kind == "window_agg2"
        acc_name = st.name + ".accumulate"
        cmb_name = st.name + ".combine"
        ordinal_map = {0: 0, 1: 1} if two_input else None
        has_late = late_sink is not None
        self.dag.vertex(acc_name,
                        lambda w=wdef, o=op, m=ordinal_map:
                        AccumulateByFrameProcessor(
                            w, o, m, allowed_lateness=lateness,
                            late_output=has_late))
        self.dag.vertex(cmb_name,
                        lambda w=wdef, o=op: CombineFramesProcessor(
                            w, o, allowed_lateness=lateness,
                            skip_late=has_late))
        # local partitioned edge(s) into the accumulator
        for i, up in enumerate(st.upstreams):
            e = Edge(self._vname(up), acc_name, dst_ordinal=i,
                     routing=Routing.PARTITIONED)
            self._connect_up(up, e)
        # distributed partitioned edge to the combiner
        e2 = Edge(acc_name, cmb_name, routing=Routing.PARTITIONED,
                  distributed=True)
        e2.src_ordinal = self._next_ordinal(acc_name, "out")
        self.dag.edge(e2)
        if has_late:
            self._wire_late_sink(st.name, acc_name, late_sink)
        self.vertex_of[st] = cmb_name

    def _plan_window_agg_device(self, st: _Stage) -> None:
        """Device placement: a block-aware vertex on a distributed
        partitioned edge, so EventBlocks route vectorized straight into
        the device packer.  Each parallel instance owns a StreamExecutor
        over its key-partition subset — partitioning of device state
        follows partitioning of compute, like the host two-stage plan."""
        from .device_window import DeviceWindowProcessor
        name = st.name + ".device"
        self.dag.vertex(
            name,
            (lambda w=st.params["wdef"], o=st.params["op"],
                    kw=st.params["device"]:
             DeviceWindowProcessor(w, o, **kw)))
        e = Edge(self._vname(st.upstreams[0]), name,
                 routing=Routing.PARTITIONED, distributed=True)
        self._connect_up(st.upstreams[0], e)
        self.vertex_of[st] = name

    def _plan_session_agg(self, st: _Stage, wdef: SessionWindowDef,
                          op: AggregateOperation, lateness: int,
                          late_sink) -> None:
        """Sessions run as ONE keyed vertex on a distributed partitioned
        edge — merging is key-local and the frame grid is data-dependent,
        so there is no two-stage split."""
        name = st.name + ".session"
        has_late = late_sink is not None
        self.dag.vertex(name,
                        lambda w=wdef, o=op: SessionWindowProcessor(
                            w, o, allowed_lateness=lateness,
                            late_output=has_late))
        e = Edge(self._vname(st.upstreams[0]), name,
                 routing=Routing.PARTITIONED, distributed=True)
        self._connect_up(st.upstreams[0], e)
        if has_late:
            self._wire_late_sink(st.name, name, late_sink)
            # the session vertex now interleaves LateEvents with results on
            # every out-edge: shield the main path with a drop filter
            flt_name = st.name + ".drop-late"
            self.dag.vertex(flt_name,
                            lambda: FusedFunctionProcessor(_drop_late_chain))
            ef = Edge(name, flt_name, routing=Routing.ISOLATED)
            ef.src_ordinal = self._next_ordinal(name, "out")
            self.dag.edge(ef)
            name = flt_name
        self.vertex_of[st] = name

    def _wire_late_sink(self, stage_name: str, src_vertex: str,
                        late_sink) -> None:
        late_name = stage_name + ".late"
        self.dag.vertex(late_name,
                        lambda s=late_sink: LateSplitProcessor(s()))
        e = Edge(src_vertex, late_name, routing=Routing.ISOLATED)
        e.src_ordinal = self._next_ordinal(src_vertex, "out")
        self.dag.edge(e)

    def _connect_up(self, up: _Stage, edge: Edge) -> None:
        src = self._vname(up)
        edge.src_ordinal = self._next_ordinal(src, "out")
        self.dag.edge(edge)

    def _plan_hash_join(self, st: _Stage) -> None:
        p = st.params
        name = st.name
        self.dag.vertex(
            name, lambda: HashJoinProcessor(
                p["probe_key_fn"], p["build_key_fn"], p["combine_fn"],
                p["inner"]))
        probe, build = st.upstreams
        # build side: broadcast + distributed, higher drain priority (0)
        eb = Edge(self._vname(build), name, dst_ordinal=1,
                  routing=Routing.BROADCAST, distributed=True, priority=0)
        self._connect_up(build, eb)
        ep = Edge(self._vname(probe), name, dst_ordinal=0,
                  routing=Routing.ISOLATED, priority=1)
        self._connect_up(probe, ep)
        self.vertex_of[st] = name


def group_aggregate(op: AggregateOperation) -> Callable[[], Processor]:
    """Supplier for a batch keyed aggregation vertex (use with
    ``custom_transform(partitioned=True, distributed=True)``)."""
    return lambda: GroupAggregateProcessor(op)
