"""AdamW with decoupled weight decay and global-norm clipping, in PyTorch.

The port of ``repro/runtime/optimizer.py``, written over a mapping of
named tensors (a model's ``named_parameters()``) rather than
``torch.optim.AdamW``, which puts the weight decay and the bias
corrections elsewhere and has no global-norm clip inside its step.  The
formulas are the reference's, in float32:

* ``count`` (int32) is incremented first; the schedule and the bias
  corrections read the new count;
* every gradient is scaled by ``min(1, clip / (gn + 1e-9))``, ``gn`` the
  global norm of all of them;
* ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g²`` (float32);
* ``p <- p - lr (mu / bc1 / (sqrt(nu / bc2) + eps) + wd p)``, computed in
  float32 and cast back to the parameter's type.

The parameters may be DTensors (a mesh): the update runs on every
rank's shards, the clip's norm is global, and the moments keep the
parameters' placements.

Where the reference returns new trees, :meth:`AdamW.update` updates the
parameters, ``mu``, ``nu`` and ``count`` **in place** and returns them: a
reader that must keep a step's state (an asynchronous checkpoint) copies
it first.  The count, the schedule and the clip stay on the parameters'
device: a step reads nothing back to the host.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor


def named_tensors(params) -> Dict[str, torch.Tensor]:
    """``params`` as ``{name: tensor}``: a module's ``named_parameters()``,
    or a mapping of tensors as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


class AdamW:
    def __init__(self, lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0,
                 warmup_steps: int = 100, total_steps: int = 10_000):
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps

    def init(self, params) -> Dict[str, object]:
        """``{"mu", "nu"}`` as float32 zeros by parameter name, and
        ``count`` a 0-d int32 zero, on the parameters' device.  DTensor
        parameters (a mesh) give moments in their placements (ZeRO-3) and a
        replicated ``count``."""
        named = named_tensors(params)
        first = next(iter(named.values()))
        zeros = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in named.items()}
        count = torch.zeros((), dtype=torch.int32, device=first.device)
        if isinstance(first, DTensor):
            mesh = first.device_mesh
            count = distribute_tensor(count, mesh,
                                      [Replicate()] * mesh.ndim,
                                      src_data_rank=None)
        return {"mu": zeros,
                "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
                "count": count}

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warm-up, then cosine decay to a tenth of ``lr``."""
        step = step.float()
        warm = torch.clamp((step + 1) / self.warmup_steps, max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(1, self.total_steps - self.warmup_steps),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * warm * (0.1 + 0.9 * cos)

    @torch.no_grad()
    def update(self, params, grads: Mapping[str, torch.Tensor],
               opt_state) -> Tuple[object, Dict[str, object]]:
        """One step over every parameter of ``params`` (a module or a
        mapping of tensors), ``grads`` by the same names; updates in place
        and returns ``(params, opt_state)``."""
        named = named_tensors(params)
        names = list(named)
        ps = [named[n] for n in names]
        mu = [opt_state["mu"][n] for n in names]
        nu = [opt_state["nu"][n] for n in names]
        count = opt_state["count"]
        count += 1
        g32 = [grads[n].float() for n in names]
        if self.clip_norm is not None:
            gn = torch.sqrt(sum(torch.sum(torch.square(g)) for g in g32))
            scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
            g32 = torch._foreach_mul(g32, scale)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g32, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g32, 1 - b2), g32))
        del g32
        c = count.float()
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        lr = self.schedule(count)

        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, bc1)
        torch._foreach_div_(step, denom)
        del denom
        p32 = [p.float() for p in ps]
        torch._foreach_add_(step, torch._foreach_mul(p32, self.weight_decay))
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(p32, step)
        for p, new in zip(ps, p32):
            if new is not p:                 # a 16-bit parameter: cast back
                p.copy_(new)
        return params, opt_state
