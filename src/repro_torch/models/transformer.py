"""Transformer assembly and single-token decode, in PyTorch.

The port of ``repro/models/transformer.py`` for the dense family.  The
reference stacks each group of layers on a leading axis and scans over
the groups with ``lax.scan``; the port holds one :class:`Block` per layer
in an ``nn.ModuleList`` and loops over them.  ``models/convert.py`` maps
one layout onto the other.  Parameters keep the reference's names, shapes
and ``(in, out)`` weight layout, in the dtype they were made in: a server
holds them in its ``compute_dtype``, so the reference's per-step
``astype(compute_dtype)`` (``transformer.py:261``, ``:272``) is a no-op
here, never a copy of the 933 MB embedding.

``sharding.constraints`` has no counterpart: without a mesh its calls are
no-ops in the reference.

Not ported yet (ROADMAP.md §1, queue item 2), and raising
``NotImplementedError``: Mamba, RWKV-6 and MoE layers, the full-sequence
``forward`` and ``prefill`` (and with them the modality stubs' precomputed
embeddings).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..devices import ieee_fp32_matmul
from . import attention as attn_mod
from .layers import apply_norm, init_mlp, init_norm, mlp, normal_init

ROADMAP_ITEM = attn_mod.ROADMAP_ITEM


def check_supported(cfg) -> None:
    """Raise for the layer kinds this port leaves out."""
    for kind in cfg.layer_kinds():
        if kind != "attn":
            raise NotImplementedError(f"{kind} layers are not ported yet "
                                      f"({ROADMAP_ITEM})")
    if "moe" in cfg.ffn_kinds():
        raise NotImplementedError(f"MoE feed-forward layers are not ported "
                                  f"yet ({ROADMAP_ITEM})")
    attn_mod.check_supported(cfg)


def _params(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Block(nn.Module):
    """One layer: ``norm1``, the attention ``mixer``, ``norm2`` and the
    SwiGLU ``ffn``, each a dict of the reference's tensors."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.norm1 = _params(tensors["norm1"])
        self.mixer = _params(tensors["mixer"])
        self.norm2 = _params(tensors["norm2"])
        self.ffn = _params(tensors["ffn"])

    def tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: dict(getattr(self, name).items())
                for name in ("norm1", "mixer", "norm2", "ffn")}


class Transformer(nn.Module):
    """Parameters of a dense decoder: ``embed`` (V, D), ``blocks``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (D, V)."""

    def __init__(self, cfg, embed: torch.Tensor,
                 blocks: List[Dict[str, Dict[str, torch.Tensor]]],
                 final_norm: Dict[str, torch.Tensor],
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        check_supported(cfg)
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} "
                             f"layers")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError("lm_head must be given exactly when the "
                             "embeddings are not tied")
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(Block(b) for b in blocks)
        self.final_norm = _params(final_norm)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg, dtype, device=None):
    return {"norm1": init_norm(cfg, dtype, device),
            "mixer": attn_mod.init_attention(gen, cfg, dtype, device),
            "norm2": init_norm(cfg, dtype, device),
            "ffn": init_mlp(gen, cfg, dtype, device)}


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Transformer:
    """Random parameters with the reference's shapes and scales
    (``transformer.py:58``), drawn from ``gen`` (a ``torch.Generator`` on
    ``device``)."""
    check_supported(cfg)
    V, D = cfg.vocab_size, cfg.d_model
    embed = normal_init(gen, (V, D), D ** -0.5, dtype, device)
    blocks = [init_block(gen, cfg, dtype, device)
              for _ in range(cfg.n_layers)]
    lm_head = (None if cfg.tie_embeddings
               else normal_init(gen, (D, V), D ** -0.5, dtype, device))
    return Transformer(cfg, embed, blocks, init_norm(cfg, dtype, device),
                       lm_head)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def apply_block(bp: Block, x: torch.Tensor, cfg, compute_dtype, *,
                cache=None, pos: Optional[int] = None):
    """Attention then SwiGLU, each behind its norm and residual
    (``transformer.py:80``).  Returns ``(x, cache)``; the reference's MoE
    auxiliary loss has no counterpart without MoE."""
    h = apply_norm(bp.norm1, x, cfg)
    y, new_cache = attn_mod.attention(bp.mixer, h, cfg,
                                      compute_dtype=compute_dtype,
                                      cache=cache, pos=pos)
    x = x + y
    h2 = apply_norm(bp.norm2, x, cfg)
    return x + mlp(bp.ffn, h2, compute_dtype), new_cache


# ---------------------------------------------------------------------------
# full sequence: not ported yet
# ---------------------------------------------------------------------------


def forward(cfg, params, *, tokens=None, embeds=None, **kw):
    raise NotImplementedError(f"the full-sequence forward (train, and the "
                              f"modality stubs' embeddings) is not ported "
                              f"yet ({ROADMAP_ITEM})")


def prefill(cfg, params, *, tokens=None, embeds=None, **kw):
    raise NotImplementedError(f"the full-sequence prefill is not ported yet "
                              f"({ROADMAP_ITEM}); serving prefills one "
                              f"prompt token per decode step")


# ---------------------------------------------------------------------------
# decode (one token against the cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """One KV cache per layer (``transformer.py:240``), each
    (batch, max_seq, Hk, dh) for k and for v."""
    check_supported(cfg)
    return [attn_mod.init_cache(cfg, batch, max_seq, dtype, device)
            for _ in range(cfg.n_layers)]


def decode_step(cfg, params: Transformer, cache, token: torch.Tensor,
                pos: int, compute_dtype=torch.bfloat16):
    """token: (B,) int32; pos: Python int (current length).  Returns
    ``(logits[B, V] float32, cache)``, the cache updated in place.
    Float32 matmuls run in IEEE float32 whatever the global TF32 setting
    (``devices.ieee_fp32_matmul``)."""
    with ieee_fp32_matmul():
        x = params.embed.to(compute_dtype).index_select(0, token)[:, None]
        for bp, bc in zip(params.blocks, cache):
            x, _ = apply_block(bp, x, cfg, compute_dtype, cache=bc, pos=pos)
        x = apply_norm(params.final_norm, x, cfg)
        head = params.embed.T if cfg.tie_embeddings else params.lm_head
        logits = (x[:, 0, :] @ head.to(compute_dtype)).float()
    return logits, cache
