"""Multi-pod dry run: every (architecture x input shape) cell on the
production meshes, in one process, on a fake world of ranks.

The port of ``repro/launch/dryrun.py``, with its CLI::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Where the reference lowers and compiles each cell for 256 or 512 host
devices, the port initialises a fake process group of 512 ranks in this
process (``torch.testing``'s ``FakeStore``, backend ``"fake"``: its
collectives move no data), builds the 16x16 or 2x16x16 mesh over it and
rank 0's view of the cell (``specs.build_cell``: meta-device DTensors),
and runs the cell's step once under three counters, each of which counts
what rank 0's device runs (the ops DTensor lowers to on the local shards):

* the arguments' bytes on one device, exact (``specs.argument_bytes``);
* the step's peak bytes on one device (:class:`LiveBytes`, the
  arguments included: ``MemTracker`` would also count the FakeTensors of
  global shape by which DTensor infers its placements);
* FLOPs on one device (``FlopCounterMode``'s formulas on the local ops);
* collective calls and bytes by kind (``CommDebugMode``; bytes are each
  call's input).

``fits_80gb`` holds the peak against the 80 GB of one H100's HBM.
Results go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.
A cell whose step raises (an op with no DTensor sharding strategy among
them) is listed under FAILURES with the error, which names the op, and
``--all`` then exits 1, as the reference's loop does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback
import weakref
from collections import defaultdict
from typing import Iterator

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

from ..configs import SHAPES, applicable_cells
from ..models.layers import repeat, repeats
from ..sharding import constraints
from .mesh import make_production_mesh
from .specs import argument_bytes, argument_tensors, build_cell

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
#: one H100's HBM
HBM_BYTES = 80e9


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A fake process group of ``n`` ranks in this process, as rank 0, for
    the block (its collectives move no data); an initialised group of at
    least ``n`` ranks is used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() < n:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is "
                               f"initialised; the dry run needs {n}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_op(types) -> bool:
    """Whether an op with tensor ``types`` is one the device runs: not a
    DTensor op (its local ops come next) and not one of the FakeTensor
    ops by which DTensor's sharding propagation infers global shapes."""
    return not any(issubclass(t, (DTensor, FakeTensor)) for t in types)


class _LocalFlops(_FlopCounterMode):
    """FlopCounterMode's formulas, on the ops DTensor lowers to: a DTensor
    op is handed on (``NotImplemented``) and counted in its local ops, as
    ``CommDebugMode`` sees the collectives.  Ops run as they come (no
    decomposition): the products, which the formulas cover, are aten ops
    of their own.  Each op counts :func:`layers.repeats` times (a meta
    scan's one step for many)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not _local_op(types) or isinstance(out, FakeTensor):
            return out
        counter, packet = self.counter, func._overloadpacket
        if packet in counter.flop_registry:
            n = counter.flop_registry[packet](*args, **(kwargs or {}),
                                              out_val=out) * repeats()
            for par in set(counter.mod_tracker.parents):
                counter.flop_counts[par][packet] += n
        return out


class LocalFlopCounter(FlopCounterMode):
    """FLOPs of one device's shards."""

    def __enter__(self):
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlops(self)
        self.mode.__enter__()
        return self


#: c10d's in-place ops (a ``local_map`` body's collectives) under the
#: functional collectives' names
_C10D_NAMES = {"allreduce": "all_reduce",
               "_allgather_base": "all_gather_into_tensor",
               "_reduce_scatter_base": "reduce_scatter_tensor",
               "alltoall_base": "all_to_all_single"}


def _kind(name: str) -> str:
    name = name.rstrip("_")
    return _C10D_NAMES.get(name, name)


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode``'s calls by kind, and the bytes of each call's
    input (its first argument: the tensor, or the list of tensors, that the
    rank hands in); c10d's in-place ops (a ``local_map`` body's) count
    under the functional collectives' names.  Each call counts
    :func:`layers.repeats` times (a meta scan's one step for many)."""

    def __init__(self):
        super().__init__()
        self.bytes = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = dict(self.comm_counts)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and self.comm_counts != before:
            n = repeats()
            for k, v in list(self.comm_counts.items()):
                self.comm_counts[k] += (v - before.get(k, 0)) * (n - 1)
            name = _kind(func._overloadpacket.__name__)
            self.bytes[name] += n * sum(
                t.numel() * t.element_size() for t in _tensors(args[:1]))
        return out

    def summary(self) -> dict:
        calls = defaultdict(int)
        for k, v in self.comm_counts.items():
            calls[_kind(getattr(k, "__name__", str(k)))] += v
        return {"calls": dict(calls), "bytes": dict(self.bytes),
                "total_bytes": sum(self.bytes.values())}


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive on one device, and their peak: each
    storage an op of the device creates (DTensor ops are handed on to
    their local ops; the sharding propagation's FakeTensors, global
    shapes that no device holds, are left out) counts from its creation
    until it is freed.  ``MemTracker`` would count those FakeTensors too."""

    def __init__(self, tensors=()):
        super().__init__()
        self._seen = weakref.WeakSet()
        self.live = self.peak = 0
        for t in tensors:
            self._track(t)

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        if storage in self._seen:
            return
        self._seen.add(storage)
        n = storage.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _local_op(types):
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and \
                        not isinstance(o, FakeTensor):
                    self._track(o)
        return out


def run_cell(arch: str, shape: str, multi_pod: bool,
             remat_policy: str = "nothing", tag: str = "",
             cache_int8: bool = False) -> dict:
    """One cell on its production mesh (a fake world is set up around it
    where none is initialised)."""
    n_ranks = 512 if multi_pod else 256
    mesh_name = "2x16x16" if multi_pod else "16x16"
    with fake_world(n_ranks):
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        cell = build_cell(arch, shape, mesh, remat_policy=remat_policy,
                          cache_dtype=torch.int8 if cache_int8
                          else torch.bfloat16)
        t_build = time.time() - t0
        args_bytes = argument_bytes(cell)
        memory = LiveBytes([t.to_local() if isinstance(t, DTensor) else t
                            for t in argument_tensors(cell)])
        flops, comms = LocalFlopCounter(display=False), CollectiveCounter()
        constraints.set_mesh(mesh)
        try:
            t1 = time.time()
            # repeat(1): whatever a step that raised left on the scope,
            # the next cell starts from 1
            with memory, flops, comms, repeat(1):
                cell.fn(*cell.args)
            t_step = time.time() - t1
        finally:
            constraints.set_mesh(None)
    peak = memory.peak
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": n_ranks,
        "kind": cell.kind, "remat": remat_policy, "tag": tag,
        "meta": cell.static_meta, "build_s": round(t_build, 1),
        "step_s": round(t_step, 1),
        "memory": {"argument_bytes": args_bytes, "peak_bytes": peak},
        "flops": flops.get_total_flops(),
        "collectives": comms.summary(),
        "fits_80gb": peak < HBM_BYTES,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="nothing",
                    choices=["nothing", "dots", "none"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = applicable_cells(args.arch)
        if args.shape:
            cells = [(a, s) for a, s in cells if s == args.shape]
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    with fake_world(max(512 if mp else 256 for mp in meshes)):
        for arch, shape in cells:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                suffix = "" if args.tag == "baseline" else "__" + args.tag
                out = OUT_DIR / f"{arch}__{shape}__{mesh_name}{suffix}.json"
                if args.skip_existing and out.exists():
                    print(f"[skip] {out.name}")
                    continue
                print(f"[dryrun] {arch} x {shape} on {mesh_name} "
                      f"(remat={args.remat}, tag={args.tag})", flush=True)
                try:
                    res = run_cell(arch, shape, mp, args.remat, args.tag)
                except Exception as e:     # a cell's failure is reported
                    traceback.print_exc()
                    failures.append((arch, shape, mesh_name,
                                     f"{type(e).__name__}: "
                                     f"{str(e).splitlines()[0][:300]}"))
                    continue
                out.write_text(json.dumps(res, indent=1))
                mem = res["memory"]
                print(f"  args/dev={mem['argument_bytes'] / 1e9:.3f} GB "
                      f"peak/dev={mem['peak_bytes'] / 1e9:.3f} GB "
                      f"fits_80gb={res['fits_80gb']} "
                      f"flops/dev={res['flops']:.3e} "
                      f"coll={res['collectives']['total_bytes']:.3e} B "
                      f"step={res['step_s']}s", flush=True)
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
