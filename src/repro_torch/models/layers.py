"""Shared layers: norms, rotary embeddings, initializers, the SwiGLU MLP.

The port of ``repro/models/layers.py``.  Parameters are plain tensors in
dicts (an ``nn.ParameterDict`` in the model) with the reference's names,
shapes and ``(in, out)`` weight layout, so ``x @ w`` reads the same in
both packages.  ``chunked_time_scan`` is the recurrent families' scan over
time (Mamba, RWKV-6).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint


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


def placed_zeros(shape, like: torch.Tensor, dims: Dict[int, int], dtype
                 ) -> torch.Tensor:
    """Zeros of ``shape`` on ``like``'s device; where ``like`` is a
    DTensor, a DTensor whose dim ``dims[d]`` is sharded as ``like``'s dim
    ``d`` is, replicated elsewhere (a scan's first carry, placed as its
    inputs)."""
    z = torch.zeros(shape, dtype=dtype, device=like.device)
    if not isinstance(like, DTensor):
        return z
    placements = [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                  else Replicate() for p in like.placements]
    return distribute_tensor(z, like.device_mesh, placements,
                             src_data_rank=None)


def _scan_per_shard(step: Callable, init, xs, chunk: int, consts):
    """:func:`chunked_time_scan` over DTensors, per shard (``local_map``):
    the recurrence is independent for every batch row and every channel
    or head, which is how its inputs are sharded, so each rank scans its
    own.  The time axis must be whole.  An input replicated on a mesh
    dimension over which the carry is split (a const such as Mamba's ``A``
    over the batch, its ``B`` and ``C`` over the channels) gets a partial
    gradient there."""
    seq = xs if isinstance(xs, tuple) else (xs,)
    if any(p.is_shard(0) for t in seq for p in t.placements):
        raise ValueError("a scan's time axis (dim 0) must not be sharded")
    mesh = init.device_mesh
    split = [not p.is_replicate() for p in init.placements]
    ins = (init, *seq, *consts)
    n = len(seq)

    def grad_placements(t):
        return tuple(Partial() if split[i] and p.is_replicate() else p
                     for i, p in enumerate(t.placements))

    def local(init, *rest):
        x = tuple(rest[:n]) if isinstance(xs, tuple) else rest[0]
        return chunked_time_scan(step, init, x, chunk, tuple(rest[n:]))

    return local_map(
        local, out_placements=(list(init.placements),
                               list(seq[0].placements)),
        in_placements=tuple(t.placements for t in ins),
        in_grad_placements=tuple(grad_placements(t) for t in ins),
        device_mesh=mesh)(*ins)


def chunked_time_scan(step: Callable, init, xs, chunk: int = 256,
                      consts: tuple = ()) -> Tuple[object, object]:
    """``carry, y = step(carry, x_t, *consts)`` over the time-major
    leading axis of ``xs`` (a tensor or a tuple of tensors); returns
    ``(carry, ys)`` with ``ys`` stacked time-major (a tensor, or a tuple
    where ``step`` returns one).  On a mesh (DTensor inputs, ``init``
    placed as the carry, e.g. by :func:`placed_zeros`) the scan runs per
    shard (:func:`_scan_per_shard`) and returns DTensors placed as
    ``init`` and ``xs``' first tensor.

    As in the reference (``layers.py:73-97``), time runs in chunks of
    ``chunk`` steps (halved until it divides the length), and where a
    graph is built each chunk is checkpointed: the backward pass keeps the
    carry only at chunk boundaries and runs a chunk again to get its
    steps', O(T / chunk + chunk) carries instead of O(T).  The values do
    not depend on ``chunk``."""
    seq = xs if isinstance(xs, tuple) else (xs,)
    if isinstance(seq[0], DTensor):
        return _scan_per_shard(step, init, xs, chunk, consts)
    T = seq[0].shape[0]
    c = min(chunk, T)
    while T % c:
        c //= 2

    def run(carry, *x_chunk):
        ys = []
        for t in range(x_chunk[0].shape[0]):
            x_t = tuple(x[t] for x in x_chunk)
            carry, y = step(carry, x_t if isinstance(xs, tuple) else x_t[0],
                            *consts)
            ys.append(y)
        if isinstance(ys[0], tuple):
            return carry, tuple(torch.stack(y) for y in zip(*ys))
        return carry, torch.stack(ys)

    if torch.is_grad_enabled() and any(x.requires_grad for x in seq):
        run = functools.partial(checkpoint, run, use_reentrant=False)
    carry, chunks = init, []
    for lo in range(0, T, c):
        carry, ys = run(carry, *(x[lo:lo + c] for x in seq))
        chunks.append(ys)
    if isinstance(chunks[0], tuple):
        return carry, tuple(torch.cat(y) for y in zip(*chunks))
    return carry, torch.cat(chunks)
