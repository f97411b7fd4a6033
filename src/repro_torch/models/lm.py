"""LM task heads: the loss, the train step, the prefill and the serve step,
in PyTorch.

The port of ``repro/models/lm.py``: ``cross_entropy`` and ``loss_fn``
(with ``MOE_AUX_COEF`` and ``IGNORE_INDEX``), ``make_train_step``,
``make_prefill``, ``make_serve_step`` and ``global_norm``.  The reference
takes its gradients with ``jax.value_and_grad`` over jnp code; the port
takes them with autograd over the same plain PyTorch modules.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from ..devices import ieee_fp32_matmul
from ..sharding.collectives import max_over, sum_over
from ..sharding.constraints import BATCH, constrain, replicated_constants
from ..sharding.rules import mesh_shape
from . import transformer

MOE_AUX_COEF = 0.01
IGNORE_INDEX = -100


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> transformer.Transformer:
    return transformer.init_params(cfg, gen, dtype, device)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    return transformer.init_cache(cfg, batch, max_seq, dtype, device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits (B, S, V) float32; labels (B, S) int with ``IGNORE_INDEX``
    masking: the mean negative log-likelihood of the kept labels
    (``lm.py:25-45``: max-shifted log-sum-exp minus the gold logit).  On a
    mesh, :func:`_nll_vocab_parallel`."""
    mask = labels != IGNORE_INDEX
    if isinstance(logits, DTensor):
        nll = _nll_vocab_parallel(logits, labels)
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    # the row max as a constant (the reference's stop_gradient)
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(shifted).sum(dim=-1))
    gold = shifted.gather(-1, safe[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _nll_vocab_parallel(logits: DTensor, labels: DTensor) -> DTensor:
    """Each token's masked negative log-likelihood, (B, S), with the
    logits' vocab sharded on ``model``: per shard (``local_map``), the row
    max and the sum of exponentials reduced over ``model``, the gold logit
    taken by the shard that holds it and summed.  The same float32 sums as
    the dense path's, and the backward stays on the shards: DTensor's
    ``gather`` would build its gradient as replicated zeros of the whole
    (B, S, V) logits on every device."""
    mesh = logits.device_mesh
    logits = constrain(logits, BATCH, None, "model")
    labels = constrain(labels, BATCH, None)
    names = list(mesh_shape(mesh))
    group = mesh.get_group("model")
    v_loc = logits.to_local().shape[-1]
    v0 = mesh.get_local_rank("model") * v_loc

    def local(lg, lab):
        mask = lab != IGNORE_INDEX
        safe = torch.where(mask, lab, torch.zeros_like(lab)).long()
        shifted = lg - max_over(lg.amax(dim=-1, keepdim=True), group)
        logz = torch.log(sum_over(torch.exp(shifted).sum(dim=-1), [group]))
        mine = (safe >= v0) & (safe < v0 + v_loc)
        idx = torch.clamp(safe - v0, 0, v_loc - 1)
        gold = sum_over(shifted.gather(-1, idx[..., None])[..., 0] * mine,
                        [group])
        return (logz - gold) * mask

    out = tuple(Replicate() if n == "model" else p
                for n, p in zip(names, labels.placements))
    return local_map(local, out_placements=list(out),
                     in_placements=(logits.placements, labels.placements),
                     device_mesh=mesh)(logits, labels)


def loss_fn(cfg, params, batch, compute_dtype=torch.bfloat16,
            remat_policy: str = "nothing"):
    """``(loss, {"ce_loss", "moe_aux"})``: cross-entropy plus
    ``MOE_AUX_COEF`` times the MoE load-balancing loss.  ``batch`` holds
    "tokens" or "embeds", and "labels"."""
    logits, aux = transformer.forward(
        cfg, params, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        compute_dtype=compute_dtype, remat_policy=remat_policy)
    loss = cross_entropy(logits, batch["labels"])
    return loss + MOE_AUX_COEF * aux, {"ce_loss": loss, "moe_aux": aux}


def make_train_step(cfg, optimizer, compute_dtype=torch.bfloat16,
                    remat_policy: str = "nothing", grad_transform=None,
                    microbatches: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``state`` = ``{"params": Transformer, "opt": optimizer state, "step":
    0-d int32 tensor}``; ``metrics`` = ``{"loss", "ce_loss", "moe_aux",
    "grad_norm"}``, 0-d tensors on the parameters' device (nothing is read
    back to the host).  The step updates the state's tensors in place and
    returns the same dict.  ``grad_transform`` maps the gradients (a dict
    by parameter name) before the update; ``grad_norm`` is their global
    norm after it and before the optimizer's clip.  ``microbatches`` = M
    > 1 splits the batch into M sequential microbatches against the same
    parameters: their float32 gradients are summed and divided by M, the
    loss and the aux are the means, and ``ce_loss`` is the mean loss, as
    in the reference (``lm.py:93-108``); on a mesh each microbatch is
    sharded over the batch axes, as the reference constrains it.  On a mesh
    (DTensor parameters and batch) the gradients are placed as the
    parameters before ``grad_transform``.  The parameters require grad only
    inside the step."""
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} < 1")

    def grads_of(params, batch):
        loss, metrics = loss_fn(cfg, params, batch, compute_dtype,
                                remat_policy)
        named = list(params.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                {n: _placed_as(g, p) for (n, p), g in zip(named, grads)})

    def accumulate(params, batch):
        M = microbatches

        def split(v):
            # on a mesh the rows of microbatch m (rows m B/M to (m+1) B/M,
            # as in the reference) lie on other devices than the batch's
            # shards: the batch is gathered whole first, then each
            # microbatch sharded over the batch axes
            v = constrain(v, *([None] * v.ndim))
            return constrain(v.reshape(M, v.shape[0] // M, *v.shape[1:]),
                             None, BATCH, *([None] * (v.ndim - 1)))

        parts = {k: split(v) for k, v in batch.items()}
        acc: Dict[str, torch.Tensor] = {}
        loss_sum = aux_sum = 0.0
        for m in range(M):
            loss, metrics, g = grads_of(params,
                                        {k: v[m] for k, v in parts.items()})
            if not acc:
                acc = {n: t.float() for n, t in g.items()}
            else:
                torch._foreach_add_(list(acc.values()),
                                    [g[n] for n in acc])
            loss_sum = loss_sum + loss
            aux_sum = aux_sum + metrics["moe_aux"]
            del g
        torch._foreach_div_(list(acc.values()), M)
        loss = loss_sum / M
        return loss, {"ce_loss": loss, "moe_aux": aux_sum / M}, acc

    def step(state, batch):
        params = state["params"]
        params.requires_grad_(True)
        try:
            # the backward pass recomputes remat'd blocks: inside too
            with ieee_fp32_matmul(), replicated_constants():
                loss, metrics, grads = (grads_of if microbatches == 1
                                        else accumulate)(params, batch)
        finally:
            params.requires_grad_(False)
        if grad_transform is not None:
            grads = grad_transform(grads)
        grad_norm = global_norm(grads)
        optimizer.update(params, grads, state["opt"])
        state["step"] += 1
        return state, dict(metrics, loss=loss, grad_norm=grad_norm)

    return step


def _placed_as(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A parameter's gradient in the parameter's placements (the
    reference's ``_constrain_grads``, ``lm.py:66-75``): a partial sum is
    reduced, a replicated gradient keeps its shard.  The identity on plain
    tensors."""
    if isinstance(grad, DTensor) and grad.placements != param.placements:
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def make_serve_step(cfg, compute_dtype=torch.bfloat16):
    """Returns ``serve(params, cache, token, pos) -> (next_token, cache)``:
    one decode step, then the greedy token as int32.  ``torch.argmax``
    returns the first of equal maxima, as ``jnp.argmax`` does.  On a mesh
    the logits are gathered over the vocab shards (replicated on
    ``model``) for the argmax."""

    def serve(params, cache, token, pos):
        logits, cache = transformer.decode_step(cfg, params, cache, token,
                                                pos, compute_dtype)
        logits = constrain(logits, BATCH, None)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve


def make_prefill(cfg, compute_dtype=torch.bfloat16):
    """Full-sequence forward for the prefill shapes, the logits only (no
    cache write: it measures the attention and FFN compute itself)."""

    def prefill(params, tokens=None, embeds=None):
        return transformer.forward(cfg, params, tokens=tokens, embeds=embeds,
                                   compute_dtype=compute_dtype)[0]

    return prefill


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The square root of the sum of every tensor's float32 sum of
    squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))
