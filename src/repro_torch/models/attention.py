"""Grouped-query attention, single-token decode against a KV cache.

The port of the decode branch of ``repro/models/attention.py``
(``attention.py:204-248``).  The reference's decode attention is
``_sdpa_decode`` in plain jnp; the port computes the same function (full
causal mask over the cache, GQA without expanding kv heads) with the
hand-written kernel ``kernels.decode_attention``, which reads the cache in
place through a permuted view.

Where the port differs from the reference in mechanism, not result:

* The cache is updated **in place**: the step's k and v are written into
  row ``slot`` of the ``(B, S_max, Hk, dh)`` tensors (the reference's
  ``dynamic_update_slice`` returns a new cache, donated by the server).
* ``dynamic_update_slice`` clamps its start index (``attention.py:232-235``),
  so a step at ``pos >= S_max`` writes row ``S_max - 1``; the port writes
  ``min(pos, S_max - 1)``, and every row is then attended.
* Cache rows are masked only by ``k_pos <= pos`` (``attention.py:243``):
  rows left by an earlier request in the same batch slot stay visible,
  as in the reference.

Not ported yet (ROADMAP.md §1, queue item 2), and raising
``NotImplementedError``: the full-sequence branch (``_sdpa_full``,
``_sdpa_chunked``, ``return_kv``), sliding-window attention and the int8
cache.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.decode_attn import decode_attention
from .layers import apply_rope, normal_init

#: where the branches this module leaves out are queued
ROADMAP_ITEM = "ROADMAP.md §1, queue item 2"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: the port runs "
                               f"dense full-attention decode only "
                               f"({ROADMAP_ITEM})")


def check_supported(cfg, cache_dtype=None) -> None:
    """Raise for the attention variants this module leaves out."""
    if cfg.attention == "swa":
        raise _not_ported("sliding-window attention (attention='swa')")
    if cache_dtype == torch.int8:
        raise _not_ported("the int8 KV cache")


def init_attention(gen: torch.Generator, cfg, dtype, device=None
                   ) -> Dict[str, torch.Tensor]:
    D, dh = cfg.d_model, cfg.head_dim_
    H, Hk = cfg.n_heads, cfg.n_kv_heads
    s = D ** -0.5
    p = {"wq": normal_init(gen, (D, H * dh), s, dtype, device),
         "wk": normal_init(gen, (D, Hk * dh), s, dtype, device),
         "wv": normal_init(gen, (D, Hk * dh), s, dtype, device),
         "wo": normal_init(gen, (H * dh, D), (H * dh) ** -0.5, dtype,
                           device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hk * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hk * dh,), dtype=dtype, device=device)
    return p


def _project_qkv(params, x: torch.Tensor, cfg, compute_dtype):
    B, S, D = x.shape
    dh, H, Hk = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    x = x.to(compute_dtype)
    q = x @ params["wq"].to(compute_dtype)
    k = x @ params["wk"].to(compute_dtype)
    v = x @ params["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    return (q.reshape(B, S, H, dh), k.reshape(B, S, Hk, dh),
            v.reshape(B, S, Hk, dh))


def attention(params, x: torch.Tensor, cfg, *, compute_dtype,
              cache: Optional[dict] = None, pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode: ``cache`` = {"k", "v"} of (B, S_max, Hk, dh),
    updated in place; ``pos`` a Python int, the current length; x is
    (B, 1, D).  Returns (y, cache).  Without a cache (the reference's
    full-sequence branch) it raises."""
    if cache is None:
        raise _not_ported("full-sequence attention (train / prefill: "
                          "_sdpa_full, _sdpa_chunked, return_kv)")
    check_supported(cfg, cache["k"].dtype)
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, compute_dtype)
    at = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, at, cfg.rope_theta)
    k = apply_rope(k, at, cfg.rope_theta)
    # dynamic_update_slice clamps the start (attention.py:232-235)
    slot = min(pos, cache["k"].shape[1] - 1)
    cache["k"][:, slot].copy_(k[:, 0])
    cache["v"][:, slot].copy_(v[:, 0])
    # the reference attends over the cache cast to compute_dtype; a cache
    # already in compute_dtype (the server's) is read in place
    kc, vc = (cache[n].to(compute_dtype).permute(0, 2, 1, 3)
              for n in ("k", "v"))
    out = decode_attention(q[:, 0], kc, vc, pos)
    y = out.to(compute_dtype).reshape(B, 1, -1) @ params["wo"].to(
        compute_dtype)
    return y, cache


def init_cache(cfg, batch: int, max_seq: int, dtype, device=None
               ) -> Dict[str, torch.Tensor]:
    """KV cache of zeros, (batch, max_seq, Hk, dh) each, the reference's
    layout."""
    check_supported(cfg, dtype)
    dh, Hk = cfg.head_dim_, cfg.n_kv_heads
    return {"k": torch.zeros((batch, max_seq, Hk, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_seq, Hk, dh), dtype=dtype,
                             device=device)}
