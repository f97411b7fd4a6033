"""Training driver, in PyTorch.

The port of ``repro/launch/train.py``, with its flags and its printed
line.  It runs on ``cuda`` unless given ``--device``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b

and here, on the CPU, at the smoke-scale config::

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 100 --batch 8 --seq 256 --reduced --device cpu \
        --ckpt-dir /tmp/ckpt

``--reduced`` computes in float32, else in bfloat16; the parameters and
AdamW's state are float32 either way.  Restart-ability: the data pipeline
is a pure function of the step (a replayable source), so ``--resume``
with ``--ckpt-dir`` restores the latest committed step and gives
exactly-once training.  The loss is read from the device only at log
steps.

``--mesh`` trains over a mesh of ranks (``launch/train.py:33-43``,
``:68-86``): the parameters, AdamW's moments and each batch are DTensors
placed by ``sharding.rules``, and the mesh is registered for the model's
constraints and its MoE path.

* ``A`` or ``AxB``: spawns A (a ``("data",)`` mesh) or A·B (``("data",
  "model")``) ranks with ``mesh.spawn_ranks``: gloo on the CPU, NCCL with
  a card a rank, and where the host has fewer cards than ranks (they share
  the cards) gloo through pinned host memory (``mesh.HostStagedGloo``).  Every rank builds the whole state from the seed and keeps
  its shards; rank 0 logs and returns the losses.
* ``16x16``, ``2x16x16``: joins a world launched from outside (``torchrun``
  and its environment, a card a rank over NCCL) and raises where the
  world has fewer than 256 or 512 ranks.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import get_config
from ..devices import resolve_device
from ..models import lm
from ..runtime.checkpoint import CheckpointManager
from ..runtime.data import SyntheticLMData
from ..runtime.optimizer import AdamW
from ..sharding import constraints, rules
from .mesh import (PRODUCTION, make_production_mesh, make_smoke_mesh,
                   ranks_backend, spawn_ranks)


def make_trainer(cfg, *, steps: int, lr: float = 3e-4,
                 compute_dtype=torch.bfloat16, microbatches: int = 1,
                 remat_policy: str = "nothing", seed: int = 0, device=None,
                 mesh=None):
    """``(state, step_fn)``: float32 parameters from ``seed`` and a fresh
    AdamW state on ``device`` (the card unless one is named:
    ``devices.resolve_device``), and the train step, with the reference's
    schedule (warm-up over ``max(2, steps // 20)`` steps, cosine decay to
    ``steps``).  With ``mesh``, the parameters are drawn whole and each
    rank keeps its shards (``rules.state_sharding``); the moments and
    ``step`` follow as DTensors."""
    device = resolve_device(device, "make_trainer")
    opt = AdamW(lr=lr, warmup_steps=max(2, steps // 20), total_steps=steps)
    step_fn = lm.make_train_step(cfg, opt, compute_dtype=compute_dtype,
                                 remat_policy=remat_policy,
                                 microbatches=microbatches)
    gen = torch.Generator(device="cpu" if device.type == "meta"
                          else device).manual_seed(seed)
    params = lm.init_params(cfg, gen, torch.float32, device=device)
    step = torch.zeros((), dtype=torch.int32, device=device)
    if mesh is not None:
        rules.distribute_module(params, mesh,
                                rules.param_sharding(mesh, params))
        step = rules.distribute(step, mesh, ())
    state = {"params": params, "opt": opt.init(params), "step": step}
    return state, step_fn


def batch_on(batch, device, mesh=None):
    """A batch of numpy arrays (``SyntheticLMData.batch_at``) as tensors on
    ``device``; with ``mesh``, as DTensors placed by
    ``rules.batch_sharding`` (each rank keeps its rows of the global
    batch)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if mesh is not None:
        specs = rules.batch_sharding(mesh, out)
        out = {k: rules.distribute(v, mesh, specs[k]) for k, v in out.items()}
    return out


def value(t: torch.Tensor) -> float:
    """A 0-d metric as a float (a DTensor's whole value)."""
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def mesh_spec(spec: str):
    """``(shape, axes)`` of a ``--mesh`` value: ``A`` is ``("data",)``,
    ``AxB`` is ``("data", "model")``, the production names as the
    reference lays them."""
    for multi_pod, name in ((False, "16x16"), (True, "2x16x16")):
        if spec == name:
            return PRODUCTION[multi_pod]
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) not in (1, 2) or min(dims) < 1:
        raise ValueError(f"--mesh {spec!r}: A, AxB, 16x16 or 2x16x16")
    return dims, ("data", "model")[:len(dims)]


def _join_world(device: torch.device) -> None:
    """Join the world a launcher set up in the environment (``torchrun``:
    ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``), a card a rank; nothing
    where there is no such world."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def _mesh_rank(rank: int, world: int, device, argv, shape, axes):
    """One rank of ``--mesh A`` or ``AxB`` (run by ``spawn_ranks``)."""
    return _train(_parse(argv), make_smoke_mesh(shape, axes, device.type),
                  device, log=rank == 0)


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--schedule-steps", type=int, default=0,
                    help="LR schedule horizon (default: --steps); set it "
                         "when a run will be resumed past --steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA card")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns rank 0's losses at the log steps."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    device = resolve_device(args.device, "training")
    if not args.mesh:
        return _train(args, None, device)
    shape, axes = mesh_spec(args.mesh)
    if args.mesh in ("16x16", "2x16x16"):
        _join_world(device)
        mesh = make_production_mesh(multi_pod=len(shape) == 3,
                                    device_type=device.type)
        return _train(args, mesh, device, log=dist.get_rank() == 0)
    # the rule table on this mesh, before any rank starts: a mesh it
    # cannot place (no "model" axis) raises here, as the reference raises
    cfg = get_config(args.arch)
    rules.state_sharding(dict(zip(axes, shape)), make_trainer(
        cfg.reduced() if args.reduced else cfg, steps=1, device="meta")[0])
    n = 1
    for d in shape:
        n *= d
    return spawn_ranks(_mesh_rank, n, backend=ranks_backend(device, n),
                       device=device.type,
                       args=(argv, shape, axes))[0]


def _train(args, mesh, device, log: bool = True):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    constraints.set_mesh(mesh)
    try:
        return _loop(args, cfg, mesh, device, log)
    finally:
        constraints.set_mesh(None)


def _loop(args, cfg, mesh, device, log: bool):
    state, step_fn = make_trainer(
        cfg, steps=args.schedule_steps or args.steps, lr=args.lr,
        compute_dtype=torch.float32 if args.reduced else torch.bfloat16,
        microbatches=args.microbatches, seed=args.seed, device=device,
        mesh=mesh)

    data = SyntheticLMData(
        cfg.vocab_size, args.batch, args.seq, seed=args.seed,
        embed_dim=cfg.d_model if cfg.modality == "vlm_stub" else None)

    ckpt = CheckpointManager(args.ckpt_dir, async_save=True) \
        if args.ckpt_dir else None
    start = 0
    if ckpt is not None and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start = int(value(state["step"]))
        if log:
            print(f"resumed from step {start}")

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(
            state, batch_on(data.batch_at(step), device, mesh))
        if (step + 1) % args.log_every == 0 or step == args.steps - 1:
            loss = value(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            tok_s = args.batch * args.seq * args.log_every / max(dt, 1e-9)
            if log:
                print(f"step {step + 1:5d}  loss {loss:8.4f}  "
                      f"grad_norm {value(metrics['grad_norm']):8.3f}  "
                      f"{tok_s:9.0f} tok/s", flush=True)
            t0 = time.time()
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(state, step + 1)
    if ckpt is not None:
        ckpt.save(state, args.steps)
        ckpt.wait()
    return losses


if __name__ == "__main__":
    main()
