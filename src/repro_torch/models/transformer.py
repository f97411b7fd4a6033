"""Transformer assembly: blocks of every layer kind, the full-sequence
forward and prefill, caches and single-token decode, in PyTorch.

The port of ``repro/models/transformer.py``.  The reference stacks each
group of layers (``cfg.layer_kinds()``: one attention layer for the dense
and MoE families, one RWKV-6 layer, or Jamba's group of 7 Mamba layers
with attention at index 4) on a leading axis and scans over the groups
with ``lax.scan``; the port holds one :class:`Block` per layer in an
``nn.ModuleList`` and loops over them.  ``models/convert.py`` maps one
layout onto the other.  Parameters keep the reference's names, shapes and
``(in, out)`` weight layout, in the dtype they were made in: a server
holds them in its ``compute_dtype`` (:func:`cast_params`, which leaves the
tensors the reference reads in float32 alone), so the reference's
per-use ``astype(compute_dtype)`` is a no-op here, never a copy of the
embedding.

Caches are lists with one dict a layer, in the reference's per-block
layout (``{k, v}``, with ``k_scale`` and ``v_scale`` for int8; ``{h,
conv}``; ``{wkv, tm_shift, cm_shift}``), and decode updates them in place.
Float32 products run in IEEE float32 whatever the global TF32 setting
(``devices.ieee_fp32_matmul``).

On a mesh (``sharding.constraints.set_mesh`` and DTensor parameters and
inputs, ``launch/train.py --mesh``) the same code runs on DTensors, whose
placements propagate op by op where the reference's GSPMD propagates
shardings.  The reference's anchors pin them: the residual stream is
sequence-parallel between blocks (``constrain_batch_seq``) and the logits
vocab-parallel (``constrain_logits``); a block's FSDP weights are
gathered over ``data`` for their use (``gather_fsdp``, their gradients
reduce-scattered back); a mixer's or FFN's input is gathered over the
sequence and its output reduced to the batch layout (``gather_seq``,
Megatron's pair around tensor-parallel products); the vocab-parallel head
runs per shard (:func:`_logits`).  Plain tensors the model makes on the
fly enter as replicated (``replicated_constants``).  Without a mesh all
of these are identities.

Parameters are made frozen (``requires_grad=False``), so serving and the
forward and prefill paths build no autograd graph; the train step
(``lm.make_train_step``) switches them on for its own forward and backward
and off again.  :func:`forward` takes the reference's ``remat_policy``
(``transformer.py:164-192``) when it builds a graph: ``"nothing"``
checkpoints each block (non-reentrant ``torch.utils.checkpoint``: only the
block's input is kept, the block runs again in the backward pass),
``"dots"`` keeps the products' outputs (``mm``, ``addmm``, ``bmm``) and
recomputes the rest, ``"none"`` keeps everything.  The reference
checkpoints each group of layers and, in a multi-layer group (Jamba's),
each block inside it again; the port's groups are its blocks.  Remat
changes what the backward pass keeps, never a value.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..devices import ieee_fp32_matmul
from ..sharding.constraints import (BATCH, constrain, constrain_batch_seq,
                                    constrain_logits, gather_fsdp,
                                    gather_seq, get_mesh,
                                    replicated_constants)
from ..sharding.rules import mesh_shape
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from .layers import apply_norm, init_mlp, init_norm, mlp, normal_init

#: tensors the reference reads in float32 whatever the compute dtype (the
#: MoE router, Mamba's A_log and D, RWKV-6's w0 and bonus u): a server keeps
#: them in the type they were made in
F32_TENSORS = frozenset({"router", "A_log", "D", "w0", "u"})
#: a block's parameter groups, in the reference's order; an RWKV-6 block
#: has no ``ffn`` (channel-mix plays that role)
SUBS = ("norm1", "mixer", "norm2", "ffn")


def _params(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Block(nn.Module):
    """One layer: ``norm1``, the ``mixer`` (attention, Mamba or RWKV-6),
    ``norm2`` and, but for RWKV-6, the ``ffn`` (SwiGLU or MoE), each a dict
    of the reference's tensors."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.subs = tuple(s for s in SUBS if s in tensors)
        for name in self.subs:
            setattr(self, name, _params(tensors[name]))

    def tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: dict(getattr(self, name).items())
                for name in self.subs}


class Transformer(nn.Module):
    """Parameters of a decoder: ``embed`` (V, D), ``blocks``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (D, V)."""

    def __init__(self, cfg, embed: torch.Tensor,
                 blocks: List[Dict[str, Dict[str, torch.Tensor]]],
                 final_norm: Dict[str, torch.Tensor],
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
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


def cast_params(params: Transformer, dtype) -> Transformer:
    """Cast every parameter to ``dtype`` in place, but for
    :data:`F32_TENSORS`, which keep their type."""
    for name, p in params.named_parameters():
        if name.rsplit(".", 1)[-1] not in F32_TENSORS:
            p.data = p.data.to(dtype)
    return params


def layer_kinds(cfg, layer: int):
    """``(mixer kind, ffn kind)`` of layer ``layer`` (groups of
    ``len(cfg.layer_kinds())`` layers)."""
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    return kinds[layer % len(kinds)], ffns[layer % len(kinds)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, kind: str, ffn_kind: str, cfg, dtype,
               device=None):
    p = {"norm1": init_norm(cfg, dtype, device)}
    if kind == "attn":
        p["mixer"] = attn_mod.init_attention(gen, cfg, dtype, device)
    elif kind == "mamba":
        p["mixer"] = mamba_mod.init_mamba(gen, cfg, dtype, device)
    elif kind == "rwkv6":
        p["mixer"] = rwkv_mod.init_rwkv6(gen, cfg, dtype, device)
        p["norm2"] = init_norm(cfg, dtype, device)
        return p                  # rwkv6 channel-mix plays the FFN role
    else:
        raise ValueError(kind)
    p["norm2"] = init_norm(cfg, dtype, device)
    p["ffn"] = (moe_mod.init_moe(gen, cfg, dtype, device) if ffn_kind == "moe"
                else init_mlp(gen, cfg, dtype, device))
    return p


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Transformer:
    """Random parameters with the reference's shapes and scales
    (``transformer.py:58``), drawn from ``gen`` (a ``torch.Generator`` on
    ``device``)."""
    V, D = cfg.vocab_size, cfg.d_model
    embed = normal_init(gen, (V, D), D ** -0.5, dtype, device)
    blocks = [init_block(gen, *layer_kinds(cfg, l), cfg, dtype, device)
              for l in range(cfg.n_layers)]
    lm_head = (None if cfg.tie_embeddings
               else normal_init(gen, (D, V), D ** -0.5, dtype, device))
    return Transformer(cfg, embed, blocks, init_norm(cfg, dtype, device),
                       lm_head)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _in_use(bp: Block, ffn_kind: str):
    """The block's parameter dicts with every FSDP-sharded weight gathered
    for this use (``constraints.gather_fsdp``); without a mesh the block
    itself.  An MoE ``ffn`` stays as placed: its ``local_map`` gathers
    the experts after routing, as the reference does."""
    if get_mesh() is None:
        return bp
    return SimpleNamespace(**{
        name: (dict(getattr(bp, name).items())
               if name == "ffn" and ffn_kind == "moe" else
               {k: gather_fsdp(v) for k, v in getattr(bp, name).items()})
        for name in bp.subs})


def apply_block(bp: Block, x: torch.Tensor, kind: str, ffn_kind: str, cfg,
                compute_dtype, *, positions=None, cache=None,
                pos: Optional[int] = None, collect_cache: bool = False,
                kv_pad_to: int = 0):
    """The mixer then the FFN, each behind its norm and residual
    (``transformer.py:80``).  Returns ``(x, aux_loss, cache)``: the MoE
    load-balancing loss (None for other FFNs, where the reference's is 0)
    and the layer's cache (decode: the one given, updated in place;
    prefill with ``collect_cache``: a new one in ``init_cache``'s layout;
    else None)."""
    aux = None
    bp = _in_use(bp, ffn_kind)
    h = gather_seq(apply_norm(bp.norm1, x, cfg))
    if kind == "attn":
        y, new_cache = attn_mod.attention(
            bp.mixer, h, cfg, positions=positions,
            compute_dtype=compute_dtype, cache=cache, pos=pos,
            return_kv=collect_cache, kv_pad_to=kv_pad_to)
        x = x + gather_seq(y)
    elif kind == "mamba":
        y, new_cache = mamba_mod.mamba(bp.mixer, h, cfg, compute_dtype,
                                       cache=cache,
                                       return_state=collect_cache)
        x = x + gather_seq(y)
    elif kind == "rwkv6":
        st = cache or {}
        y, wkv, tm_shift = rwkv_mod.time_mix(
            bp.mixer, h, cfg, compute_dtype, state=st.get("wkv"),
            shift_state=st.get("tm_shift"))
        x = x + gather_seq(y)
        h2 = gather_seq(apply_norm(bp.norm2, x, cfg))
        y2, cm_shift = rwkv_mod.channel_mix(
            bp.mixer, h2, cfg, compute_dtype,
            shift_state=st.get("cm_shift"))
        new_cache = {"wkv": wkv, "tm_shift": tm_shift, "cm_shift": cm_shift}
        if cache is not None:
            for name, t in new_cache.items():
                cache[name].copy_(t)
            new_cache = cache
        elif collect_cache:
            # the shift states are views of the whole (B, S, D) inputs:
            # copies let those go (F12)
            new_cache.update(tm_shift=tm_shift.clone(),
                             cm_shift=cm_shift.clone())
        else:
            new_cache = None
        return x + gather_seq(y2), aux, new_cache
    else:
        raise ValueError(kind)
    h2 = gather_seq(apply_norm(bp.norm2, x, cfg))
    if ffn_kind == "moe":
        y2, aux = moe_mod.moe_ffn(bp.ffn, h2, cfg, compute_dtype)
    else:
        y2 = mlp(bp.ffn, h2, compute_dtype)
    return x + gather_seq(y2), aux, new_cache


def _embed(params: Transformer, tokens, embeds, compute_dtype):
    """The lookup as ``F.embedding`` (``embed[tokens]``): DTensor shards
    it over a vocab-sharded table where torch 2.11 has no strategy for
    ``aten.index``."""
    if embeds is None:
        return F.embedding(tokens, params.embed.to(compute_dtype))
    return embeds.to(compute_dtype)


def _head(cfg, params: Transformer, compute_dtype) -> torch.Tensor:
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return head.to(compute_dtype)


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``(x @ head)`` in float32.  On a mesh the vocab-parallel product
    runs per shard (``local_map``): x whole on ``model``, the head's
    vocab shard, the logits' vocab shard, so that their gradient comes
    back in that layout too (DTensor's propagation through the loss could
    hand it back sharded on the tokens); x's gradient is a partial sum
    over ``model``, the head's over the batch axes."""
    if not isinstance(x, DTensor):
        return (x @ head).float()
    mesh = x.device_mesh
    x = constrain(x, BATCH, None, None)
    head = constrain(head, None, "model")
    names = list(mesh_shape(mesh))
    batch = [names.index(a) for a in BATCH if a in names]
    out = tuple(Shard(2) if i == names.index("model") else p
                for i, p in enumerate(x.placements))
    x_grad = tuple(Partial() if i == names.index("model") else p
                   for i, p in enumerate(x.placements))
    head_grad = tuple(Partial() if i in batch else p
                      for i, p in enumerate(head.placements))
    return local_map(lambda a, b: (a @ b).float(), out_placements=list(out),
                     in_placements=(x.placements, head.placements),
                     in_grad_placements=(x_grad, head_grad),
                     device_mesh=mesh)(x, head)


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


#: the products whose outputs ``remat_policy="dots"`` keeps (the
#: reference's ``dots_with_no_batch_dims_saveable``: matmuls; the port's
#: batched products are ``bmm``)
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.bmm.default)
REMAT_POLICIES = ("nothing", "dots", "none")


def _remat(fn, policy: str):
    """``fn`` under ``policy``'s checkpoint (see the module docstring)."""
    if policy == "nothing":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         list(SAVED_DOTS)))
    return fn


def forward(cfg, params: Transformer, *, tokens=None, embeds=None,
            positions=None, compute_dtype=torch.bfloat16,
            remat_policy: str = "nothing"):
    """Returns ``(logits[B, S, V] float32, moe_aux_loss)``: tokens (B, S)
    through the embedding, or ``embeds`` (B, S, D) as the modality stubs
    give them.  ``remat_policy`` applies where a graph is built (grad
    mode on and trainable parameters)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} not in "
                         f"{REMAT_POLICIES}")
    if not (torch.is_grad_enabled() and params.embed.requires_grad):
        remat_policy = "none"
    with ieee_fp32_matmul(), replicated_constants():
        x = constrain_batch_seq(_embed(params, tokens, embeds, compute_dtype))
        S = x.shape[1]
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for l, bp in enumerate(params.blocks):
            kind, ffn_kind = layer_kinds(cfg, l)

            def block(x, bp=bp, kind=kind, ffn_kind=ffn_kind):
                y, aux, _ = apply_block(bp, x, kind, ffn_kind, cfg,
                                        compute_dtype, positions=positions)
                return constrain_batch_seq(y), aux

            x, aux = _remat(block, remat_policy)(x)
            if aux is not None:
                aux_total = aux_total + aux
        x = gather_seq(apply_norm(params.final_norm, x, cfg))
        logits = constrain_logits(_logits(x, _head(cfg, params,
                                                   compute_dtype)))
    return logits, aux_total


# ---------------------------------------------------------------------------
# prefill (full sequence -> last-token logits + cache for decode)
# ---------------------------------------------------------------------------


def prefill(cfg, params: Transformer, *, tokens=None, embeds=None,
            compute_dtype=torch.bfloat16, kv_pad_to: int = 0):
    """Serving prefill: run the full sequence, return ``(last_logits[B, V],
    cache)`` with the cache laid out as :func:`init_cache` and decode expect
    (attention fills the KV cache, the recurrent layers hand over their
    final state)."""
    with ieee_fp32_matmul(), replicated_constants():
        x = constrain_batch_seq(_embed(params, tokens, embeds, compute_dtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        caches = []
        for l, bp in enumerate(params.blocks):
            x, _, c = apply_block(bp, x, *layer_kinds(cfg, l), cfg,
                                  compute_dtype, positions=positions,
                                  collect_cache=True, kv_pad_to=kv_pad_to)
            x = constrain_batch_seq(x)
            caches.append(c)
        x = apply_norm(params.final_norm, gather_seq(x)[:, -1:, :], cfg)
        logits = (x[:, 0, :] @ _head(cfg, params, compute_dtype)).float()
    return logits, caches


# ---------------------------------------------------------------------------
# decode (one token against the cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """One cache a layer (``transformer.py:240``): a KV cache for
    attention (``dtype=torch.int8`` quantizes it), the state for Mamba and
    RWKV-6 (float32 states; the shift and conv inputs in ``dtype``)."""
    out = []
    for l in range(cfg.n_layers):
        kind, _ = layer_kinds(cfg, l)
        if kind == "attn":
            out.append(attn_mod.init_cache(cfg, batch, max_seq, dtype,
                                           device))
        elif kind == "mamba":
            out.append(mamba_mod.init_mamba_cache(cfg, batch, dtype, device))
        else:
            out.append(rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device))
    return out


def decode_step(cfg, params: Transformer, cache, token: torch.Tensor,
                pos: int, compute_dtype=torch.bfloat16):
    """token: (B,) int32; pos: Python int (current length).  Returns
    ``(logits[B, V] float32, cache)``, the cache updated in place."""
    with ieee_fp32_matmul(), replicated_constants():
        x = constrain_batch_seq(
            params.embed.to(compute_dtype).index_select(0, token)[:, None])
        for l, (bp, bc) in enumerate(zip(params.blocks, cache)):
            x, _, _ = apply_block(bp, x, *layer_kinds(cfg, l), cfg,
                                  compute_dtype, cache=bc, pos=pos)
            x = constrain_batch_seq(x)
        x = apply_norm(params.final_norm, x, cfg)
        logits = (x[:, 0, :] @ _head(cfg, params, compute_dtype)).float()
    return logits, cache
