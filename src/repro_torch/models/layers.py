"""Shared layers: norms, rotary embeddings, initializers, the SwiGLU MLP.

The port of ``repro/models/layers.py``.  Parameters are plain tensors in
dicts (an ``nn.ParameterDict`` in the model) with the reference's names,
shapes and ``(in, out)`` weight layout, so ``x @ w`` reads the same in
both packages.  ``chunked_time_scan`` belongs to the SSM families, which
the port does not run yet (ROADMAP.md §1, queue item 2).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device=None) -> torch.Tensor:
    """N(0, 1) drawn in float32 from ``gen``, times ``scale``, cast to
    ``dtype``, as the reference draws it (its numbers differ: another
    generator)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def init_norm(cfg, dtype, device=None) -> Dict[str, torch.Tensor]:
    if cfg.norm == "nonparametric_ln":
        return {}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def apply_norm(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm, LayerNorm or OLMo's non-parametric LayerNorm, computed in
    float32 and cast back to the input's dtype (``layers.py:22-35``)."""
    dt = x.dtype
    x = x.float()
    if cfg.norm == "rmsnorm":
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.norm_eps)
        return (x * params["scale"].float()).to(dt)
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + cfg.norm_eps)
    if cfg.norm == "nonparametric_ln":          # OLMo: no learned affine
        return x.to(dt)
    return (x * params["scale"].float() + params["bias"].float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, dh, 2) / dh)`` in float32, as written in
    ``layers.py:38-40``."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    Rotates the two halves of the head dimension (not interleaved pairs),
    angles in float32 (``layers.py:43-52``)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)            # (dh/2,)
    angles = positions[..., None].float() * freqs             # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, cfg, dtype, device=None
             ) -> Dict[str, torch.Tensor]:
    D, Fd = cfg.d_model, cfg.d_ff
    s_in, s_out = D ** -0.5, Fd ** -0.5
    return {"w_gate": normal_init(gen, (D, Fd), s_in, dtype, device),
            "w_up": normal_init(gen, (D, Fd), s_in, dtype, device),
            "w_down": normal_init(gen, (Fd, D), s_out, dtype, device)}


def mlp(params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """SwiGLU feed-forward."""
    x = x.to(compute_dtype)
    h = (F.silu(x @ params["w_gate"].to(compute_dtype))
         * (x @ params["w_up"].to(compute_dtype)))
    return h @ params["w_down"].to(compute_dtype)
