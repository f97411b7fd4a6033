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
steps.  ``--mesh`` (the production and smoke meshes) waits for the mesh
layer and raises.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..devices import resolve_device
from ..models import lm
from ..runtime.checkpoint import CheckpointManager
from ..runtime.data import SyntheticLMData
from ..runtime.optimizer import AdamW

#: where the production and smoke meshes are queued
MESH_ITEM = "ROADMAP.md §1, queue item 6"


def make_trainer(cfg, *, steps: int, lr: float = 3e-4,
                 compute_dtype=torch.bfloat16, microbatches: int = 1,
                 remat_policy: str = "nothing", seed: int = 0, device=None):
    """``(state, step_fn)``: float32 parameters from ``seed`` and a fresh
    AdamW state on ``device``, and the train step, with the reference's
    schedule (warm-up over ``max(2, steps // 20)`` steps, cosine decay to
    ``steps``)."""
    opt = AdamW(lr=lr, warmup_steps=max(2, steps // 20), total_steps=steps)
    step_fn = lm.make_train_step(cfg, opt, compute_dtype=compute_dtype,
                                 remat_policy=remat_policy,
                                 microbatches=microbatches)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), torch.float32, device=device)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return state, step_fn


def batch_on(batch, device):
    """A batch of numpy arrays (``SyntheticLMData.batch_at``) as tensors on
    ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None):
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
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(f"--mesh {args.mesh}: the production and "
                                  f"smoke meshes are not ported yet "
                                  f"({MESH_ITEM})")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device, "training")
    state, step_fn = make_trainer(
        cfg, steps=args.schedule_steps or args.steps, lr=args.lr,
        compute_dtype=torch.float32 if args.reduced else torch.bfloat16,
        microbatches=args.microbatches, seed=args.seed, device=device)

    data = SyntheticLMData(
        cfg.vocab_size, args.batch, args.seq, seed=args.seed,
        embed_dim=cfg.d_model if cfg.modality == "vlm_stub" else None)

    ckpt = CheckpointManager(args.ckpt_dir, async_save=True) \
        if args.ckpt_dir else None
    start = 0
    if ckpt is not None and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start = int(state["step"])
        print(f"resumed from step {start}")

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, batch_on(data.batch_at(step), device))
        if (step + 1) % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            tok_s = args.batch * args.seq * args.log_every / max(dt, 1e-9)
            print(f"step {step + 1:5d}  loss {loss:8.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):8.3f}  "
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
