"""LM task heads: the loss, the prefill and the serve step, in PyTorch.

The port of ``repro/models/lm.py``: ``cross_entropy`` and ``loss_fn``
(with ``MOE_AUX_COEF`` and ``IGNORE_INDEX``), ``make_prefill`` and
``make_serve_step``.  ``make_train_step`` waits for the training loop
(ROADMAP.md §1, queue item 5) and raises.
"""

from __future__ import annotations

import torch

from . import transformer

MOE_AUX_COEF = 0.01
IGNORE_INDEX = -100
#: where the training half is queued
TRAIN_ITEM = "ROADMAP.md §1, queue item 5"


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
    (``lm.py:25-45``: max-shifted log-sum-exp minus the gold logit)."""
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(shifted).sum(dim=-1))
    gold = shifted.gather(-1, safe[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(cfg, params, batch, compute_dtype=torch.bfloat16):
    """``(loss, {"ce_loss", "moe_aux"})``: cross-entropy plus
    ``MOE_AUX_COEF`` times the MoE load-balancing loss.  ``batch`` holds
    "tokens" or "embeds", and "labels"."""
    logits, aux = transformer.forward(
        cfg, params, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        compute_dtype=compute_dtype)
    loss = cross_entropy(logits, batch["labels"])
    return loss + MOE_AUX_COEF * aux, {"ce_loss": loss, "moe_aux": aux}


def make_train_step(cfg, optimizer, compute_dtype=torch.bfloat16, **kw):
    raise NotImplementedError(f"the train step is not ported yet: it needs "
                              f"the optimizer and the training loop "
                              f"({TRAIN_ITEM})")


def make_serve_step(cfg, compute_dtype=torch.bfloat16):
    """Returns ``serve(params, cache, token, pos) -> (next_token, cache)``:
    one decode step, then the greedy token as int32.  ``torch.argmax``
    returns the first of equal maxima, as ``jnp.argmax`` does."""

    def serve(params, cache, token, pos):
        logits, cache = transformer.decode_step(cfg, params, cache, token,
                                                pos, compute_dtype)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve


def make_prefill(cfg, compute_dtype=torch.bfloat16):
    """Full-sequence forward for the prefill shapes, the logits only (no
    cache write: it measures the attention and FFN compute itself)."""

    def prefill(params, tokens=None, embeds=None):
        return transformer.forward(cfg, params, tokens=tokens, embeds=embeds,
                                   compute_dtype=compute_dtype)[0]

    return prefill
