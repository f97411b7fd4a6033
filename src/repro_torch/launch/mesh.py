"""The port's mesh: one ``"data"`` dimension over torch.distributed ranks.

Counterpart of ``repro/launch/mesh.py:33`` (``make_smoke_mesh``).  Where
the reference lays one program over many devices, the port runs one
process per shard: :func:`make_data_mesh` wraps ranks of an initialised
process group in a :class:`~torch.distributed.device_mesh.DeviceMesh`, and
:func:`spawn_ranks` starts such processes.  The backend (``"nccl"`` or
``"gloo"``) is always the caller's choice.

The production meshes and the multi-pod dry runs have no counterpart yet
(ROADMAP.md §1, queue item 6).
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


def mesh_ranks(mesh: DeviceMesh) -> List[int]:
    """The global ranks of ``mesh``'s shards, in shard order."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def _rank_main(rank: int, fn, world_size: int, backend: str, device: str,
               args: tuple, tmp: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
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
