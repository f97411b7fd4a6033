"""The reference's mesh collectives, under its names, over torch.distributed.

The reference runs its step under ``shard_map`` and calls ``jax.lax``'s
collectives over the ``"data"`` axis; the port runs one process per shard
and calls torch.distributed over the mesh's ``"data"`` group:

* ``psum_scatter(x, dim, tiled=True)`` -> ``reduce_scatter_tensor``;
* ``pmin``, ``pmax``, ``psum`` -> ``all_reduce``;
* ``all_to_all(x, 0, 0, tiled=True)`` -> ``all_to_all_single``;
* ``ppermute`` on the ring (and the point-to-point moves of a migration)
  -> ``batch_isend_irecv``.

A :class:`Transport` holds the group and decides how each collective's
buffers travel.  On an NCCL group, CUDA tensors go as they are; on a gloo
group, CPU tensors go as they are, and so do CUDA tensors for the
collectives gloo runs on them itself (``GLOO_CUDA_NATIVE``).  gloo's
point-to-point moves read a CUDA pointer as host memory and abort the
process (an H100 with torch 2.11 and its gloo), so those buffers are
staged through pinned host memory, explicitly, and their bytes counted
(``host_staged_bytes``, both directions).  Any other combination raises.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: ``reduce_scatter_tensor`` under its newer name where torch has it
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
#: collectives that gloo runs on CUDA tensors itself; the others stage
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "reduce_scatter",
                              "all_to_all"})


class Transport:
    """This rank's end of a mesh's ``"data"`` group."""

    def __init__(self, mesh: DeviceMesh):
        if mesh.get_coordinate() is None:
            raise ValueError("this rank holds no shard of the mesh")
        self.group = mesh.get_group("data")
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = str(dist.get_backend(self.group))
        #: bytes copied between the card and pinned host memory for gloo
        self.host_staged_bytes = 0
        #: collectives called (a test reads that emission calls none)
        self.calls = 0
        #: bytes this rank handed to collectives (each call's input)
        self.collective_bytes = 0

    def global_rank(self, group_rank: int) -> int:
        return dist.get_global_rank(self.group, group_rank)

    def staged(self, op: str, t: torch.Tensor, sent: int) -> bool:
        """Whether ``op`` on tensors on ``t``'s device goes through pinned
        host memory; counts the call and the ``sent`` bytes."""
        self.calls += 1
        self.collective_bytes += sent
        dev = t.device.type
        if self.backend == "nccl" and dev == "cuda":
            return False
        if self.backend == "gloo" and dev == "cpu":
            return False
        if self.backend == "gloo" and dev == "cuda":
            return op not in GLOO_CUDA_NATIVE
        raise ValueError(f"{op}: no route for {dev} tensors over a "
                         f"{self.backend} group")

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.host_staged_bytes += _nbytes(t)
        return host

    def from_host(self, host: torch.Tensor, out: torch.Tensor) -> None:
        out.copy_(host)
        self.host_staged_bytes += _nbytes(host)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_reduce(tr: Transport, x: torch.Tensor, op) -> torch.Tensor:
    if tr.staged("all_reduce", x, _nbytes(x)):
        host = tr.to_host(x)
        dist.all_reduce(host, op=op, group=tr.group)
        tr.from_host(host, x)
    else:
        dist.all_reduce(x, op=op, group=tr.group)
    return x


def pmin(tr: Transport, x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.pmin`` over the group, in place on ``x``; returns ``x``."""
    return _all_reduce(tr, x, dist.ReduceOp.MIN)


def pmax(tr: Transport, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(tr, x, dist.ReduceOp.MAX)


def psum(tr: Transport, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(tr, x, dist.ReduceOp.SUM)


def psum_scatter(tr: Transport, x: torch.Tensor, dim: int = 1
                 ) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, scatter_dimension=dim, tiled=True)``: the
    sum over the group of ``x``, of which this rank keeps block ``rank``
    of ``dim`` (size ``x.shape[dim] / n``).  torch scatters dim 0, so the
    blocks are first laid out along a new leading axis."""
    n = tr.size
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    blocks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    out = torch.empty(blocks.shape[1:], dtype=x.dtype, device=x.device)
    # flat buffers: every backend takes an input n times the output's length
    flat_in = blocks.contiguous().view(-1)
    if tr.staged("reduce_scatter", x, _nbytes(x)):
        host_out = torch.empty(out.numel(), dtype=out.dtype, pin_memory=True)
        _reduce_scatter(host_out, tr.to_host(flat_in), group=tr.group)
        tr.from_host(host_out.view(out.shape), out)
    else:
        _reduce_scatter(out.view(-1), flat_in, group=tr.group)
    return out


def all_to_all(tr: Transport, x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: block ``j`` of
    dim 0 goes to rank ``j``; block ``j`` of the result came from rank
    ``j``."""
    if x.shape[0] % tr.size:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                         f"{tr.size} ways")
    x = x.contiguous()
    out = torch.empty_like(x)
    if tr.staged("all_to_all", x, _nbytes(x)):
        host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_to_all_single(host_out, tr.to_host(x), group=tr.group)
        tr.from_host(host_out, out)
    else:
        dist.all_to_all_single(out, x, group=tr.group)
    return out


def send_recv(tr: Transport,
              sends: Sequence[Tuple[int, torch.Tensor]],
              recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
    """Point-to-point moves in one ``batch_isend_irecv``: each ``(peer,
    tensor)`` of ``sends`` goes to group rank ``peer``; each of ``recvs``
    is filled from its peer.  Peers are ranks of this transport's group."""
    if not sends and not recvs:
        return
    stage = tr.staged("send_recv", (sends or recvs)[0][1],
                      sum(_nbytes(t) for _, t in sends))
    ops: List[dist.P2POp] = []
    host_recvs = []
    for peer, t in sends:
        buf = tr.to_host(t) if stage else t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, tr.global_rank(peer),
                              tr.group))
    for peer, t in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) \
            if stage else t
        host_recvs.append((buf, t))
        ops.append(dist.P2POp(dist.irecv, buf, tr.global_rank(peer),
                              tr.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if stage:
        for buf, t in host_recvs:
            tr.from_host(buf, t)


def ppermute_ring(tr: Transport, x: torch.Tensor, shift: int
                  ) -> torch.Tensor:
    """``jax.lax.ppermute`` with ``perm = [(i, (i + shift) % n)]``: this
    rank's ``x`` goes to rank ``rank + shift``; returns what rank
    ``rank - shift`` sent."""
    n = tr.size
    if n == 1:
        return x.clone()
    out = torch.empty_like(x)
    send_recv(tr, [((tr.rank + shift) % n, x)],
              [((tr.rank - shift) % n, out)])
    return out
