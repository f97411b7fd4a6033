"""LM task heads: the serve step, in PyTorch.

The port of the serving half of ``repro/models/lm.py``.  The training
half (``cross_entropy``, ``loss_fn``, ``make_train_step``) and
``make_prefill`` wait for the full-sequence forward and the training
loop (ROADMAP.md §1, queue items 2 and 5).
"""

from __future__ import annotations

import torch

from . import transformer


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> transformer.Transformer:
    return transformer.init_params(cfg, gen, dtype, device)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    return transformer.init_cache(cfg, batch, max_seq, dtype, device)


def make_serve_step(cfg, compute_dtype=torch.bfloat16):
    """Returns ``serve(params, cache, token, pos) -> (next_token, cache)``:
    one decode step, then the greedy token as int32.  ``torch.argmax``
    returns the first of equal maxima, as ``jnp.argmax`` does."""

    def serve(params, cache, token, pos):
        logits, cache = transformer.decode_step(cfg, params, cache, token,
                                                pos, compute_dtype)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve
