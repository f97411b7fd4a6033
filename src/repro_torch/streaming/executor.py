"""StreamExecutor: the device-tier Jet runtime, in PyTorch.

The port of ``repro/streaming/executor.py``.  One step ingests an event
batch, accumulates it into the pane matrix (Jet stage 1, the hand-written
``window_agg`` kernel) and emits every window the watermark has closed
(stage 2).  What the reference gets from ``jit`` the port gets from
updating state in place (see ``window.py``); hence ``snapshot`` and
``restore`` return copies, never the live tensors.

On a mesh (``launch.mesh.make_data_mesh``) the port runs one process per
data shard where the reference runs one program under ``shard_map``; the
reference's collectives become ``streaming.collectives``' over the mesh's
``"data"`` group.  Partitioning of state is partitioning of compute: key
bucket ``k`` lives on shard ``k // K_loc`` with ``K_loc = K / n`` (the
reference's docstring says ``k % n``; its code, which the port follows,
owns buckets block-wise).  Each rank stages its contiguous slice
``[r B / n, (r + 1) B / n)`` of a global batch (the reference's
``P("data")``); the ``wm`` hint is replicated.  Two exchange plans:

* ``"reduce"`` (executor.py:118-173): stage 1 accumulates this rank's slice
  into full-width ``(R, K)`` panes, one ``psum_scatter`` combines them and
  leaves each rank its ``(R, K / n)`` block;
* ``"route"`` (:175-252): events go to their bucket's owner first, in one
  ``all_to_all`` of a ``(n, 4, C)`` send buffer laid out by the
  ``route_pack`` kernel (a counting sort over ``route_counts`` and
  ``route_offsets``), ``C = max(8, int(B / n / n * factor))`` cells per
  destination; overflow counts into ``dropped_conflict``.

Either way the watermark is ``pmin``-ed, ``slot_frame`` ``pmax``-ed and
the drop counters ``psum``-med as per-shard deltas, so every rank holds the
same replicated values (the same ``psum`` sums the slices' valid events
for the admission telemetry, which reads it only in ``admissible``); the
emission loop then depends on nothing else and needs no collective.
``step`` returns this rank's shard: panes ``(R, K / n)``, results ``(EB,
K / n)``, the rest replicated.  ``snapshot`` ring-shifts the panes to
rank ``i + 1`` (rank ``i``'s backup holds rank ``i - 1``'s panes) and
``restore`` shifts them back; ``migrate_state`` re-lays a state out on a
mesh that holds, or is held by, this one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..devices import resolve_device
from ..kernels.route import MAX_DEST, route_pack
from ..launch.mesh import mesh_ranks
from . import collectives as coll
from .window import (VectorWindowSpec, accumulate, emit,
                     step as window_step, window_state_init)

ACK_INTERVAL_S = 0.1
WINDOW_FILL_FACTOR = 3
#: per-event batch fields: sharded over the mesh (the rest is replicated)
EVENT_FIELDS = ("ts", "key", "value", "valid")


@dataclasses.dataclass(frozen=True)
class StreamJobConfig:
    window: VectorWindowSpec
    batch_size: int = 4096          # events per step (global)
    snapshot_every: int = 0         # steps between snapshots (0 = off)
    #: keyed-exchange plan on a mesh (ignored on one device):
    #:  - "reduce": stage 1 accumulates FULL-width panes locally, one
    #:    psum_scatter combines and deposits (bytes ~ R*K a shard: wins
    #:    when the key space is small);
    #:  - "route": events all-to-all to their bucket owners first, panes
    #:    stay owner-local (bytes ~ events a shard: wins when R*K >> batch,
    #:    and is Jet's own exchange-operator plan).  Per-destination
    #:    capacity = route_capacity_factor x fair share; overflow counts
    #:    into ``dropped_conflict``.
    exchange: str = "reduce"
    route_capacity_factor: float = 2.0


def _to_host_tensor(v) -> torch.Tensor:
    """A CPU tensor of ``v`` in the dtypes the reference's device arrays
    have: JAX's default 32-bit mode stores int64 as int32 and float64 as
    float32 on ``device_put``, and so does the port."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.require(v, requirements="C"))
    if t.dtype == torch.int64:
        t = t.to(torch.int32)
    elif t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t


class StreamExecutor:
    """Single-device executor (``mesh=None``) or this rank's shard of an
    SPMD one over ``mesh``'s ``"data"`` dimension; on ``cuda`` unless
    ``device`` says otherwise (``device="cpu"`` runs every kernel's plain
    version)."""

    #: device-held step outputs are copied to the host in chunks of this
    #: many steps, bounding live buffers without a per-step copy
    COLLECT_CHUNK = 64

    def __init__(self, cfg: StreamJobConfig,
                 mesh: Optional[DeviceMesh] = None, device=None):
        if cfg.exchange not in ("reduce", "route"):
            raise ValueError(f"exchange must be 'reduce' or 'route', got "
                             f"{cfg.exchange!r}")
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh "
                            f"(launch.mesh.make_data_mesh), got "
                            f"{type(mesh).__name__}")
        self.device = resolve_device(device, "the executor")
        self.cfg = cfg
        self.mesh = mesh
        spec = cfg.window
        #: this rank's shard index; None where the rank is outside the mesh
        self.rank: Optional[int] = 0
        self.transport: Optional[coll.Transport] = None
        if mesh is None:
            self.n_shards = 1
        else:
            if mesh.mesh_dim_names != ("data",):
                raise ValueError(f"mesh dimensions {mesh.mesh_dim_names}, "
                                 f"expected ('data',)")
            if mesh.device_type != self.device.type:
                raise ValueError(f"mesh on {mesh.device_type}, executor on "
                                 f"{self.device}")
            self.n_shards = mesh.size()
            coord = mesh.get_coordinate()
            self.rank = None if coord is None else coord[0]
            if self.rank is not None:
                self.transport = coll.Transport(mesh)
        n = self.n_shards
        if spec.n_key_buckets % n or cfg.batch_size % n:
            raise ValueError(f"{n} shards must divide the key buckets "
                             f"({spec.n_key_buckets}) and the batch "
                             f"({cfg.batch_size})")
        if mesh is not None and cfg.exchange == "route" and n > MAX_DEST:
            raise ValueError(f"the route plan ranks events by warp votes: "
                             f"at most {MAX_DEST} shards, got {n}")
        self.k_loc = spec.n_key_buckets // n
        self.b_loc = cfg.batch_size // n
        #: per-destination capacity of the route plan (executor.py:182)
        self.capacity = max(8, int(self.b_loc / n *
                                   cfg.route_capacity_factor))
        self._loc_spec = dataclasses.replace(spec, n_key_buckets=self.k_loc)
        self._partial: Optional[torch.Tensor] = None
        # telemetry for the adaptive receive window; on a mesh the step's
        # events are the psum of the slices' counts, a device scalar read
        # only when admissible() takes the rate
        self._processed_since_ack = 0
        self._processed_on_device = None if mesh is None else torch.zeros(
            (), dtype=torch.int64, device=self.device)
        self._last_ack = time.monotonic()
        self._receive_window = cfg.batch_size * WINDOW_FILL_FACTOR
        # emission-loop telemetry: rounds run and host syncs they cost
        self.emit_rounds = 0
        self.host_syncs = 0

    def _require_shard(self) -> None:
        if self.rank is None:
            raise RuntimeError("this rank holds no shard of the executor's "
                               "mesh")

    def init_state(self) -> Optional[Dict[str, torch.Tensor]]:
        """A fresh state (this rank's shard on a mesh; None on a rank
        outside the mesh)."""
        if self.rank is None:
            return None
        return window_state_init(self._loc_spec, device=self.device)

    # ------------------------------------------------------------ steps --
    def _replicate_counters(self, state, late0, conflict0, valid,
                            extra_conflict=None) -> None:
        """The drop counters as replicated sums: each shard's delta since
        the step began, ``psum``-med, added to the step's start value.  The
        same ``psum`` sums the slices' valid events (``valid`` is this
        rank's slice) into the admission telemetry: the global batch's
        count, as the reference takes it before sharding (executor.py:
        316)."""
        conflict = state["dropped_conflict"] - conflict0
        if extra_conflict is not None:
            conflict = conflict + extra_conflict
        deltas = torch.stack([state["dropped_late"] - late0, conflict,
                              valid.sum(dtype=torch.int32)])
        coll.psum(self.transport, deltas)
        state["dropped_late"].copy_(late0 + deltas[0])
        state["dropped_conflict"].copy_(conflict0 + deltas[1])
        self._processed_on_device += deltas[2]

    def _step_reduce(self, state, batch):
        """executor.py:118-173: accumulate this rank's slice into zeroed
        full-width panes (the flat pane index of ``accumulate`` works in the
        (R, K) layout), then keep this rank's block of their sum."""
        spec, tr = self.cfg.window, self.transport
        if self._partial is None:
            self._partial = torch.empty(
                (spec.ring_len, spec.n_key_buckets), dtype=torch.float32,
                device=self.device)
        partial = self._partial.zero_()
        late0 = state["dropped_late"].clone()
        conflict0 = state["dropped_conflict"].clone()
        # slot_frame, watermark and the counters are updated in place
        accumulate(spec, dict(state, panes=partial), batch["ts"],
                   batch["key"], batch["value"], batch["valid"],
                   batch.get("wm"))
        coll.pmin(tr, state["watermark"])
        state["panes"] += coll.psum_scatter(tr, partial, dim=1)
        self._replicate_counters(state, late0, conflict0, batch["valid"])
        coll.pmax(tr, state["slot_frame"])
        return emit(self._loc_spec, state)

    def _step_route(self, state, batch):
        """executor.py:175-252: pack, all-to-all, accumulate the events
        this rank owns into its (R, K / n) panes."""
        spec, tr, n = self.cfg.window, self.transport, self.n_shards
        ts, valid = batch["ts"], batch["valid"]
        wm0 = state["watermark"].clone()
        late0 = state["dropped_late"].clone()
        conflict0 = state["dropped_conflict"].clone()
        pack = route_pack(ts, batch["key"], batch["value"], valid, n,
                          self.k_loc, self.capacity, with_pos=False)
        recv = coll.all_to_all(tr, pack.send)              # (n, 4, C)
        planes = recv.transpose(0, 1).reshape(4, -1)       # sources in order
        accumulate(self._loc_spec, state, planes[0],
                   planes[1] - self.rank * self.k_loc,
                   planes[2].view(torch.float32), planes[3] != 0,
                   batch.get("wm"))
        # the watermark frontier comes from the PRE-ROUTE local slice,
        # trailing by wm_lag; pmin, then the hint (executor.py:221-230)
        wm = wm0
        if spec.frontier_from_data:
            frontier = torch.where(valid, ts, -1).amax().to(torch.int32) \
                - spec.wm_lag
            wm = torch.maximum(frontier, wm0)
        coll.pmin(tr, wm)
        hint = batch.get("wm")
        if hint is not None:
            wm = torch.maximum(wm, torch.as_tensor(hint, dtype=torch.int32,
                                                   device=wm.device))
        state["watermark"].copy_(wm)
        coll.pmax(tr, state["slot_frame"])
        self._replicate_counters(state, late0, conflict0, valid,
                                 pack.n_overflow)
        return emit(self._loc_spec, state)

    def step(self, state, batch, valid_count: Optional[int] = None):
        """One step on ``batch`` (tensors on this executor's device, e.g.
        from :meth:`stage_batch`; on a mesh, this rank's slice); updates
        ``state`` in place and returns ``(state, out)``.  On one device,
        pass ``valid_count`` (host-side event count, known at staging time)
        to spare the admission telemetry a sync.  On a mesh the telemetry
        takes the psum of the slices' counts whatever ``valid_count`` says
        (no rank knows the other slices' counts on the host)."""
        self._require_shard()
        if batch["ts"].device != self.device:
            raise ValueError(f"batch on {batch['ts'].device}, executor on "
                             f"{self.device}: stage it with stage_batch")
        if self.mesh is None:
            state, out = window_step(self.cfg.window, state, batch)
            if valid_count is None:
                valid_count = int(batch["valid"].sum())
            self._processed_since_ack += valid_count
        elif self.cfg.exchange == "route":
            state, out = self._step_route(state, batch)
        else:
            state, out = self._step_reduce(state, batch)
        self.emit_rounds += out["rounds"]
        self.host_syncs += out["host_syncs"]
        return state, out

    def stage_batch(self, batch: Dict) -> Tuple[Dict, int]:
        """Begin the host->device transfer of ``batch`` (numpy arrays or
        CPU tensors) without blocking.

        On a mesh, the per-event fields of a global batch (``batch_size``
        rows) are cut to this rank's slice first; a batch of ``batch_size /
        n`` rows is taken as the slice itself.  Other fields (``wm``) are
        replicated.  On ``cuda`` each field is copied from pinned host
        memory with ``non_blocking=True`` on the current stream (a field
        already pinned is not copied again on the host).  Returns
        ``(device_batch, valid_count)``: the count of the valid events in
        the batch it was given (the whole global batch's, as the
        reference's executor.py:316 counts before sharding; a slice's when
        given a slice), taken on the host before the transfer so the hot
        loop never syncs for it.
        """
        self._require_shard()
        lo = self.rank * self.b_loc
        staged, count = {}, 0
        for k, v in batch.items():
            if v is None:
                staged[k] = None
                continue
            t = _to_host_tensor(v)
            if k == "valid":
                count = int(t.sum())
            if self.mesh is not None and k in EVENT_FIELDS:
                if t.shape[0] == self.cfg.batch_size:
                    t = t[lo:lo + self.b_loc]
                elif t.shape[0] != self.b_loc:
                    raise ValueError(
                        f"{k} has {t.shape[0]} rows: expected the global "
                        f"batch ({self.cfg.batch_size}) or this rank's "
                        f"slice ({self.b_loc})")
            if self.device.type == "cuda":
                if not t.is_pinned():
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            staged[k] = t
        return staged, count

    # -------------------------------------------------------- snapshots --
    def snapshot(self, state) -> Dict[str, torch.Tensor]:
        """A consistent copy of ``state`` at a step boundary.  On a mesh the
        panes ring-shift to the next shard, the in-memory backup replica
        (executor.py:255-270): rank ``i``'s backup holds rank ``i - 1``'s
        panes.  The live state changes in place, so every other entry is a
        clone, never an alias."""
        self._require_shard()
        backup = {k: v.clone() for k, v in state.items() if k != "panes"}
        backup["panes"] = state["panes"].clone() if self.mesh is None \
            else coll.ppermute_ring(self.transport, state["panes"], 1)
        return backup

    def restore(self, backup) -> Dict[str, torch.Tensor]:
        """A live state from ``backup`` (executor.py:272-286): on a mesh
        each shard's panes come back from its ring neighbour; the backup
        stays intact for a later restore."""
        self._require_shard()
        state = {k: v.clone() for k, v in backup.items() if k != "panes"}
        state["panes"] = backup["panes"].clone() if self.mesh is None \
            else coll.ppermute_ring(self.transport, backup["panes"], -1)
        return state

    # ---------------------------------------------------------- elastic --
    def migrate_state(self, state, target: "StreamExecutor"):
        """Elastic rescale (executor.py:289): re-lay this mesh's sharded
        state out on ``target``'s mesh, key buckets re-partitioned block-
        wise.  One mesh must hold the other's ranks (4 -> 8 and 8 -> 4);
        every rank of the larger calls this, with ``state`` None where it
        holds no shard.  Each column block moves point to point from the
        rank that holds it to the rank that will; each target shard takes
        the replicated entries from the source of its first bucket.
        Returns this rank's target shard, or None outside ``target``'s
        mesh."""
        if self.mesh is None or target.mesh is None:
            raise ValueError("migrate_state moves a state between two "
                             "meshes")
        spec = self.cfg.window
        if target.cfg.window != spec:
            raise ValueError("the target runs another window spec")
        src, dst = mesh_ranks(self.mesh), mesh_ranks(target.mesh)
        if set(src) <= set(dst):
            outer = target.mesh
        elif set(dst) <= set(src):
            outer = self.mesh
        else:
            raise ValueError(f"neither mesh holds the other's ranks: "
                             f"{src} and {dst}")
        me = dist.get_rank()
        everyone = mesh_ranks(outer)
        if me not in everyone:
            return None
        tr = coll.Transport(outer)
        R = spec.ring_len
        ks, kt = self.k_loc, target.k_loc
        s_me = src.index(me) if me in src else None
        t_me = dst.index(me) if me in dst else None
        if (state is None) != (s_me is None):
            raise ValueError("state must be given exactly where this rank "
                             "holds a shard of the source mesh")
        new = None if t_me is None else window_state_init(
            target._loc_spec, device=target.device)

        def replicated(st):
            return torch.cat([st["slot_frame"], torch.stack(
                [st[k] for k in ("watermark", "next_emit", "dropped_late",
                                 "dropped_conflict")])])

        sends, recvs, landing = [], [], []
        for t, t_rank in enumerate(dst):
            for s, s_rank in enumerate(src):
                lo, hi = max(s * ks, t * kt), min((s + 1) * ks, (t + 1) * kt)
                if lo >= hi or me not in (s_rank, t_rank):
                    continue
                piece = None if s_me is None else \
                    state["panes"][:, lo - s * ks:hi - s * ks]
                first = s == (t * kt) // ks     # source of t's first bucket
                if s_rank == t_rank == me:
                    new["panes"][:, lo - t * kt:hi - t * kt] = piece
                    if first:
                        landing.append(replicated(state))
                elif s_rank == me:
                    sends.append((everyone.index(t_rank), piece.contiguous()))
                    if first:
                        sends.append((everyone.index(t_rank),
                                      replicated(state)))
                else:
                    buf = torch.empty((R, hi - lo), dtype=torch.float32,
                                      device=target.device)
                    recvs.append((everyone.index(s_rank), buf))
                    landing.append((lo - t * kt, hi - t * kt, buf))
                    if first:
                        rep = torch.empty(R + 4, dtype=torch.int32,
                                          device=target.device)
                        recvs.append((everyone.index(s_rank), rep))
                        landing.append(rep)
        coll.send_recv(tr, sends, recvs)
        if new is None:
            return None
        for item in landing:
            if isinstance(item, tuple):
                lo, hi, buf = item
                new["panes"][:, lo:hi] = buf
            else:
                new["slot_frame"].copy_(item[:R])
                for j, k in enumerate(("watermark", "next_emit",
                                       "dropped_late", "dropped_conflict")):
                    new[k].copy_(item[R + j])
        return new

    # adaptive receive window (paper §3.3): how many events the source may
    # admit before the next ack
    def admissible(self) -> int:
        now = time.monotonic()
        if now - self._last_ack >= ACK_INTERVAL_S:
            if self._processed_on_device is not None:
                self._processed_since_ack += int(self._processed_on_device)
                self._processed_on_device.zero_()
            rate = self._processed_since_ack
            if rate > 0:
                target = rate * WINDOW_FILL_FACTOR
                self._receive_window = max(
                    self.cfg.batch_size,
                    (self._receive_window + target) // 2)
            self._processed_since_ack = 0
            self._last_ack = now
        return self._receive_window

    # ------------------------------------------------------------ bench --
    def run_stream(self, event_gen: Callable[[int, int], Dict],
                   n_steps: int, collect: bool = True):
        """Drive ``n_steps`` steps; returns (state, results list).

        ``results`` holds ``(window_ends, rows)`` numpy pairs, one per step
        that emitted, as the reference's ``run_stream`` returns them (on a
        mesh, ``rows`` are this rank's columns).  Step ``i`` asks
        ``event_gen(start, size)`` for its events: the global batch
        ``(i B, B)`` on one device, this rank's slice ``(i B + r B / n, B /
        n)`` on a mesh, so no rank makes another's events.  Batch ``i+1``
        is staged host->device before step ``i`` runs.  A step's valid rows
        (a prefix of its output buffer) are cut out on the device; only
        they are copied to the host, a chunk at a time — never the whole
        ``(EB, K)`` buffer the reference's ``_harvest`` converts
        (executor.py:367-373: 66 MB a step at the paper's configuration).
        """
        self._require_shard()
        state = self.init_state()
        results: List[Tuple[np.ndarray, np.ndarray]] = []
        pending = []

        def _harvest():
            for ends, rows in pending:
                results.append((ends.cpu().numpy(), rows.cpu().numpy()))
            pending.clear()

        B = self.cfg.batch_size
        lo = self.rank * self.b_loc
        snap_every = self.cfg.snapshot_every

        def events(i):
            return event_gen(i * B + lo, self.b_loc)

        nxt, nxt_count = self.stage_batch(events(0))
        for i in range(n_steps):
            batch, count = nxt, nxt_count
            if i + 1 < n_steps:
                # pipelining: next batch's transfer is queued ahead of this
                # step's kernels
                nxt, nxt_count = self.stage_batch(events(i + 1))
            state, out = self.step(state, batch, valid_count=count)
            if snap_every and (i + 1) % snap_every == 0:
                self._last_backup = self.snapshot(state)
            n = out["rows"]
            if collect and n:
                pending.append((out["window_ends"][:n].clone(),
                                out["results"][:n].clone()))
                if len(pending) >= self.COLLECT_CHUNK:
                    _harvest()
        _harvest()
        return state, results
