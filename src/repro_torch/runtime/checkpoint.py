"""Checkpointing: disk tier + IMDG (in-memory, replicated) tier.

The port of ``repro/runtime/checkpoint.py``, with the same protocol:

* ``save(state, step)`` writes ``arrays.npz`` and ``meta.json`` into
  ``.tmp_step_*``, then the ``COMMIT`` marker, then renames the directory
  to ``step_*`` (optionally from a background thread, so serialization
  overlaps the next step), and with an ``imap_service`` puts every array
  into the IMap ``__ckpt.<step>`` as well;
* ``latest_step`` trusts only committed directories: a torn write is
  invisible, as in the snapshot store's commit protocol;
* ``keep`` bounds the committed checkpoints (and their IMaps) kept.

The state is a tree of tensors: dicts, lists and tuples of tensors, and
``nn.Module``s, whose parameters are leaves by name.  A leaf's name is its
path joined with ``/`` (a parameter's dots become ``/`` too).

Where the reference's host copy is of immutable arrays, the port's
optimizer updates its tensors in place, and ``.cpu()`` of a CPU tensor is
the tensor itself: ``save`` copies every leaf into host memory of its own
before it returns, or the next step would write into what the thread is
serializing.  ``restore`` copies into ``state_like``'s tensors in place, so
they keep their devices and types, and returns ``state_like``.

On a mesh the state's tensors are DTensors: ``save`` gathers each whole
(every rank calls it) and rank 0 alone writes; ``restore`` reads the whole
arrays on every rank and copies each rank's shard into the placements of
``state_like`` (``checkpoint.py:106-119``).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ..state import IMap, IMapService


def _leaves(state, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(state, nn.Module):
        for name, p in state.named_parameters():
            yield prefix + name.replace(".", "/"), p
    elif isinstance(state, dict):
        for k, v in state.items():
            yield from _leaves(v, f"{prefix}{str(k).replace('.', '/')}/")
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from _leaves(v, f"{prefix}{i}/")
    elif isinstance(state, torch.Tensor):
        yield prefix[:-1], state
    else:
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a "
                        f"{type(state).__name__}, not a tensor")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy array that shares no memory with ``t`` (bfloat16, which
    numpy lacks, as float32: the restore casts back exactly); a DTensor
    whole (every rank of its mesh takes part)."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    return t.to("cpu", copy=True).numpy()


def _flatten(state) -> List[Tuple[str, np.ndarray]]:
    return [(name, _host_copy(t)) for name, t in _leaves(state)]


@torch.no_grad()
def _restore_into(state_like, get):
    for name, leaf in _leaves(state_like):
        a = get(name)
        if a is None:
            raise KeyError(f"missing {name} in the checkpoint")
        whole = torch.from_numpy(np.asarray(a))
        if isinstance(leaf, DTensor):       # this rank's shard of it
            shard = distribute_tensor(
                whole.to(leaf.device, leaf.dtype), leaf.device_mesh,
                leaf.placements, src_data_rank=None)
            leaf.to_local().copy_(shard.to_local())
        else:
            leaf.copy_(whole)
    return state_like


def _writes() -> bool:
    """Whether this process writes: in a multi-rank world, rank 0 alone."""
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 2,
                 async_save: bool = False,
                 imap_service: Optional[IMapService] = None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.imap_service = imap_service
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------
    def save(self, state, step: int) -> None:
        flat = _flatten(state)       # device->host copy, our own, here
        if not _writes():
            return
        if self.async_save:
            self.wait()              # at most one in-flight save
            self._thread = threading.Thread(
                target=self._write, args=(flat, step), daemon=True)
            self._thread.start()
        else:
            self._write(flat, step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, flat, step: int) -> None:
        d = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{n: a for n, a in flat})
        (tmp / "meta.json").write_text(json.dumps({"step": step}))
        (tmp / "COMMIT").write_text("ok")
        if d.exists():
            shutil.rmtree(d)
        tmp.rename(d)
        if self.imap_service is not None:
            imap = IMap(self.imap_service, f"__ckpt.{step}")
            for n, a in flat:
                imap.put(n, a)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
            if self.imap_service is not None:
                IMap(self.imap_service, f"__ckpt.{s}").destroy()

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "COMMIT").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None):
        """Copy the checkpoint at ``step`` (default: the latest committed)
        into ``state_like``'s tensors, on their devices and in their
        types; returns ``state_like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        with np.load(self.dir / f"step_{step:010d}" / "arrays.npz") as arrays:
            return _restore_into(state_like,
                                 lambda n: arrays[n] if n in arrays.files
                                 else None)

    def restore_from_imap(self, state_like, step: int):
        """Fast tier: rebuild from the replicated in-memory copy (survives
        node loss via IMap backup promotion)."""
        if self.imap_service is None:
            raise RuntimeError("this manager has no IMap tier")
        imap = IMap(self.imap_service, f"__ckpt.{step}")
        return _restore_into(state_like, imap.get)
