"""Meshes over torch.distributed ranks, and the rank launcher.

The port of ``repro/launch/mesh.py``.  Where the reference lays one
program over many devices, the port runs one process per shard: a mesh is
a :class:`~torch.distributed.device_mesh.DeviceMesh` over ranks of an
initialised process group, and :func:`spawn_ranks` starts such processes.
The backend (``"nccl"`` or ``"gloo"``) is always the caller's choice.

* :func:`make_production_mesh`: the reference's ``(16, 16)`` mesh named
  ``("data", "model")``, or ``(2, 16, 16)`` named ``("pod", "data",
  "model")``, over the first 256 or 512 ranks of the default group;
* :func:`make_smoke_mesh`: any shape over the first ranks;
* :func:`make_data_mesh`: one ``"data"`` dimension over chosen ranks (the
  device tier's executor).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh


def make_data_mesh(device_type: str = "cuda",
                   ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh with one ``"data"`` dimension over ``ranks`` (default: every
    rank of the default group), in that order: shard ``i`` lives on
    ``ranks[i]``.  Every rank of the default group calls it, members or
    not, since the dimension's group is created collectively; on a rank
    outside ``ranks`` the mesh's ``get_coordinate()`` is None.  On
    ``cuda``, each rank selects its card before (``spawn_ranks`` does)."""
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed first: the backend "
                           "is the caller's choice")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if not ranks or sorted(set(ranks)) != sorted(ranks) or \
            min(ranks) < 0 or max(ranks) >= world:
        raise ValueError(f"ranks {ranks} must be distinct ranks of a world "
                         f"of {world}")
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data",))


#: the reference's production meshes (launch/mesh.py:15-29)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_smoke_mesh(shape: Sequence[int] = (2, 2),
                    axes: Sequence[str] = ("data", "model"),
                    device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the first ``prod(shape)``
    ranks of the default group, row-major.  Every rank of the group calls
    it (the dimensions' groups are created collectively)."""
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed first: the backend "
                           "is the caller's choice")
    shape, axes = tuple(int(d) for d in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"{len(axes)} names for mesh shape {shape}")
    n = 1
    for d in shape:
        n *= d
    world = dist.get_world_size()
    if n > world:
        raise RuntimeError(f"mesh {shape} needs {n} ranks but the world has "
                           f"{world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The 16x16 mesh (256 ranks) or, with ``multi_pod``, the 2x16x16 one
    (512), over the ranks of the default group.  Raises where the world is
    smaller, naming the ranks it needs, as the reference raises for
    devices."""
    shape, axes = PRODUCTION[multi_pod]
    n = 1
    for d in shape:
        n *= d
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks but the world has "
                           f"{world}; launch {n} ranks (one a card), or a "
                           f"fake world of {n} for a dry run")
    return make_smoke_mesh(shape, axes, device_type)


def mesh_ranks(mesh: DeviceMesh) -> List[int]:
    """The global ranks of ``mesh``'s shards, in shard order."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


class HostStagedGloo(dist.ProcessGroup):
    """gloo for CUDA tensors, every collective staged through pinned host
    memory: the backend ``"gloo_host"`` (:func:`register_host_gloo`).

    gloo runs ``all_reduce``, ``reduce_scatter``, ``all_to_all`` and
    ``all_gather_into_tensor`` on CUDA tensors when called through c10d,
    but with torch 2.11 a functional collective (how DTensor redistributes)
    on a CUDA tensor over gloo ended its process with SIGSEGV in
    ``wait_tensor`` (an H100, 4 ranks sharing it).  This group copies each
    input to pinned host memory, runs the collective on a gloo group of
    its own on the host, waits for it, copies the result back, and
    returns completed work: ranks sharing a card (where NCCL refuses two
    ranks on one device) get every collective DTensor and ``local_map``
    bodies call.  ``staged_bytes`` counts the bytes it copies, both ways.
    CPU tensors pass through without a copy.  The functional collectives
    call the ``*_coalesced`` forms even for one tensor: a form this class
    did not override would fall to c10d's base, which asks for a device
    backend a Python group does not register (``No backend type
    associated with device type cuda``)."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self.staged_bytes = 0

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.staged_bytes += t.numel() * t.element_size()
        return host

    def _back(self, host: torch.Tensor, t: torch.Tensor) -> None:
        if host is not t:
            t.copy_(host)
            self.staged_bytes += t.numel() * t.element_size()

    @staticmethod
    def _done(result=None):
        fut = torch.futures.Future()
        fut.set_result(result)
        return torch._C._distributed_c10d._create_work_from_future(fut)

    def allreduce(self, tensors, opts=None):
        hosts = [self._host(t) for t in tensors]
        self._gloo.allreduce(hosts, opts or dist.AllreduceOptions()).wait()
        for h, t in zip(hosts, tensors):
            self._back(h, t)
        return self._done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        one = dist.AllreduceOptions()
        if opts is not None:
            one.reduceOp = opts.reduceOp
        for t in tensors:
            self.allreduce([t], one)
        return self._done(tensors)

    def _allgather_base(self, output, input, opts=None):
        out, inp = self._host(output), self._host(input)
        self._gloo._allgather_base(out, inp,
                                   opts or dist.AllgatherOptions()).wait()
        self._back(out, output)
        return self._done(output)

    all_gather_single = _allgather_base

    def allgather(self, output_lists, inputs, opts=None):
        outs = [[self._host(t) for t in lst] for lst in output_lists]
        ins = [self._host(t) for t in inputs]
        self._gloo.allgather(outs, ins, opts or dist.AllgatherOptions()
                             ).wait()
        for lst, hlst in zip(output_lists, outs):
            for t, h in zip(lst, hlst):
                self._back(h, t)
        return self._done(output_lists)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts)
        return self._done(outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        out, inp = self._host(output), self._host(input)
        self._gloo._reduce_scatter_base(
            out, inp, opts or dist.ReduceScatterOptions()).wait()
        self._back(out, output)
        return self._done(output)

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return self._done(outputs)

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        out, inp = self._host(output), self._host(input)
        self._gloo.alltoall_base(out, inp, output_split_sizes,
                                 input_split_sizes,
                                 opts or dist.AllToAllOptions()).wait()
        self._back(out, output)
        return self._done(output)

    all_to_all_single = alltoall_base

    def broadcast(self, tensors, opts=None):
        hosts = [self._host(t) for t in tensors]
        self._gloo.broadcast(hosts, opts or dist.BroadcastOptions()).wait()
        for h, t in zip(hosts, tensors):
            self._back(h, t)
        return self._done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return self._done()

    def getBackendName(self) -> str:
        return "gloo_host"

    @property
    def group_name(self) -> str:
        """c10d's name of this group (as it registered it)."""
        return dist.distributed_c10d._world.pg_names[self]


def register_host_gloo() -> None:
    """Make ``"gloo_host"`` (:class:`HostStagedGloo`) a backend
    ``init_process_group`` takes; idempotent."""
    if "gloo_host" not in dist.Backend.backend_list:
        dist.Backend.register_backend(
            "gloo_host", lambda store, rank, size, timeout:
            HostStagedGloo(store, rank, size, timeout),
            devices=["cpu", "cuda"])


def ranks_backend(device: torch.device, n: int) -> str:
    """The backend for ``n`` ranks on ``device``'s type: NCCL with a card a
    rank; ranks sharing cards stage through host memory (``"gloo_host"``);
    gloo on the CPU."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= n else "gloo_host"


def _rank_main(rank: int, fn, world_size: int, backend: str, device: str,
               args: tuple, tmp: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    if backend == "gloo_host":
        register_host_gloo()
    dev = torch.device(device)
    if dev.type == "cuda":
        index = rank % torch.cuda.device_count() if dev.index is None \
            else dev.index
        torch.cuda.set_device(index)
        torch.cuda.init()
        dev = torch.device("cuda", index)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world_size, dev, *args)
        out = os.path.join(tmp, f"result-{rank}.pkl")
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], world_size: int, *, backend: str,
                device: str, args: tuple = (),
                timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size``
    processes started with ``spawn`` (CUDA does not survive ``fork``) and
    return their results in rank order.

    Each process sets one thread, selects its card (``rank % cards`` when
    ``device`` is ``"cuda"``), and joins a ``backend`` group through a file
    rendezvous in a fresh temporary directory, so concurrent launches never
    share a port.  ``fn`` must be importable by its module path and its
    result picklable.  A rank that raises ends the others and raises here;
    ``timeout_s`` bounds every collective and the whole run, after which
    every process is ended and ``TimeoutError`` raised."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, device, args, tmp,
                              timeout_s),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running "
                                       f"after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"result-{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
