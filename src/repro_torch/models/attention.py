"""Grouped-query attention: full / sliding-window, chunked online-softmax
for long sequences, and single-token decode against a KV cache.

The port of ``repro/models/attention.py``.  The full-sequence branch
(train / prefill: ``_sdpa_full``, ``_sdpa_chunked``) is plain PyTorch, as
the reference's is plain jnp.  Single-token decode runs the hand-written
kernel ``kernels.decode_attention`` (the reference's ``_sdpa_decode`` is
jnp), which reads the cache in place through a permuted view.

Types follow the reference: scores are float32 products of the inputs in
their own type (``preferred_element_type=jnp.float32``, so a bf16 score is
never rounded to bf16), probabilities are cast to v's type before the PV
product, and a PV product of 16-bit inputs rounds to their type.

On a mesh, the q/k/v projections are placed as the reference's
``constrain_heads`` places them before the split into heads, and the
full-sequence core runs per shard (:func:`_sdpa_on_mesh`).

Where the port differs from the reference in mechanism, not result:

* The cache is updated **in place**: the step's k and v are written into
  row ``slot`` of the ``(B, S_max, Hk, dh)`` tensors (the reference's
  ``dynamic_update_slice`` returns a new cache, donated by the server).
* ``dynamic_update_slice`` clamps its start index (``attention.py:232-235``),
  so a step at ``pos >= S_max`` writes row ``S_max - 1``; the port writes
  ``min(slot, S_max - 1)``, and every row is then attended.
* Cache rows are masked only by ``k_pos <= pos`` (``attention.py:243``):
  rows left by an earlier request in the same batch slot stay visible,
  as in the reference.
* Sliding-window decode.  A rolling cache (``S_max <= W``, what
  ``init_cache`` builds) holds position ``p`` at slot ``p % S_max``; the
  kernel attends slots ``<= pos`` (all once ``pos >= S_max``), which is
  the reference's mask: softmax does not care about slot order, and every
  slot lies inside the window.  A linear cache (``S_max > W``, only from
  ``prefill(..., kv_pad_to > W)``) also masks ``pos - k_pos >= W``: the
  kernel's lower bound ``lo = pos - W + 1``.  The reference rolls a
  prefill longer than the window into ``W`` slots and then pads it past
  ``W`` (``:197-201``), and such a padded cache is indexed linearly
  (``:209-213``): kept as it is.
* int8 cache: the step's k and v are quantized per (position, kv head)
  with float16 scales (round half to even in both packages), the whole
  cache is dequantized to ``compute_dtype`` as the reference does
  (``:224-229``), then the kernel runs on that copy.
* Past ``S_max + W - 1`` on a linear sliding-window cache the reference's
  mask is empty, and its softmax averages every row; the port's lower
  bound stops at the last row, which it then attends alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.decode_attn import decode_attention, decode_attention_plain
from ..sharding.constraints import (BATCH, constrain, constrain_flat_heads,
                                    constrain_heads, gather_unsplit_heads,
                                    get_mesh)
from ..sharding.rules import distribute, mesh_shape
from .layers import apply_rope, normal_init

NEG_INF = -1e30
#: the chunked (online-softmax) path runs for S > CHUNK_THRESHOLD
CHUNK_THRESHOLD = 4096
KV_CHUNK = 1024
#: position of the chunked path's padding keys: never attended
PAD_POS = 2 ** 30


def _expand_kv(k: torch.Tensor, G: int) -> torch.Tensor:
    """Repeat kv heads to the full query-head count (``jnp.repeat`` on
    the head axis)."""
    return k if G == 1 else k.repeat_interleave(G, dim=2)


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
    return (constrain_flat_heads(q, H).reshape(B, S, H, dh),
            constrain_flat_heads(k, Hk).reshape(B, S, Hk, dh),
            constrain_flat_heads(v, Hk).reshape(B, S, Hk, dh))


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, cfg) -> torch.Tensor:
    """(Sq, Sk) causal mask, with the window for sliding-window attention."""
    mask = k_pos[None, :] <= q_pos[:, None]
    if cfg.attention == "swa":
        mask &= (q_pos[:, None] - k_pos[None, :]) < cfg.swa_window
    return mask


def _pv(p: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, p.astype(v.dtype), v)``: float32 sums of the products,
    rounded to v's type (XLA's dot of 16-bit inputs)."""
    return torch.einsum(eq, p.to(v.dtype).float(), v.float()).to(v.dtype)


def _sdpa_full(q, k, v, q_pos, k_pos, cfg) -> torch.Tensor:
    """Dense causal (+ SWA) attention. q: (B,Sq,H,dh), k/v: (B,Sk,Hk,dh)."""
    dh = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    k, v = _expand_kv(k, G), _expand_kv(v, G)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (dh ** -0.5)
    scores = scores.masked_fill(~_mask(q_pos, k_pos, cfg)[None, None],
                                NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _pv(probs, v, "bhqk,bkhd->bqhd")


def _sdpa_chunked(q, k, v, q_pos, k_pos, cfg, chunk: int = KV_CHUNK
                  ) -> torch.Tensor:
    """Online softmax over KV chunks; memory O(Sq * chunk) per head.  The
    last chunk is padded with zero keys at position ``PAD_POS``."""
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    Sk = k.shape[1]
    n_chunks = -(-Sk // chunk)
    dt = q.dtype
    q = (q * (dh ** -0.5)).float()
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, Sk)
        k_i, v_i = k[:, lo:hi], v[:, lo:hi]
        p_i = k_pos[lo:hi]
        if hi - lo < chunk:
            pad = chunk - (hi - lo)
            k_i = torch.nn.functional.pad(k_i, (0, 0, 0, 0, 0, pad))
            v_i = torch.nn.functional.pad(v_i, (0, 0, 0, 0, 0, pad))
            p_i = torch.nn.functional.pad(p_i, (0, pad), value=PAD_POS)
        k_i, v_i = _expand_kv(k_i, G), _expand_kv(v_i, G)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_i.float())
        s = s.masked_fill(~_mask(q_pos, p_i, cfg)[None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + _pv(p, v_i, "bhqk,bkhd->bhqd").float()
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(dt)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands back a contiguous gradient: the
    core's products give q, k and v permuted gradients, and DTensor views
    of the split heads need their shards contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _core(sdpa, cfg):
    def run(q, k, v, q_pos, k_pos):
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        return sdpa(q, k, v, q_pos, k_pos, cfg).contiguous()
    return run


def _sdpa_on_mesh(sdpa, q, k, v, positions, cfg) -> DTensor:
    """The attention core on a mesh, per shard (``local_map``): each rank
    runs ``sdpa`` on its batch rows and its heads, or, where the heads do
    not divide the ``model`` axis, on its chunk of the queries against the
    whole sequence.  These are the reference's ``constrain_heads`` and
    ``constrain_scores`` anchors (``attention.py:101-105``, ``:130-136``)
    as placements: the core needs no collective, and the products never
    flatten a dimension sharded over two mesh dimensions.  On the query
    fallback, every ``model`` rank's gradient of k and v is a partial
    sum."""
    mesh = get_mesh()
    G = q.shape[2] // k.shape[2]
    k, v = _expand_kv(k, G), _expand_kv(v, G)
    q = constrain_heads(q)
    names = list(mesh_shape(mesh))
    m = names.index("model")
    heads = q.placements[m] == Shard(2)
    if heads:
        k, v = constrain_heads(k), constrain_heads(v)
    else:                       # the queries' chunk: the keys whole
        k, v = (constrain(t, BATCH, None, None, None) for t in (k, v))
    q_pos = distribute(positions, mesh,
                       ("model",) if q.placements[m] == Shard(1) else (None,))
    k_pos = distribute(positions, mesh, (None,))
    kv_grad = tuple(Partial() if i == m and not heads else p
                    for i, p in enumerate(k.placements))
    core = local_map(
        _core(sdpa, cfg),
        out_placements=list(q.placements),
        in_placements=(q.placements, k.placements, v.placements,
                       q_pos.placements, k_pos.placements),
        in_grad_placements=(q.placements, kv_grad, kv_grad,
                            q_pos.placements, k_pos.placements),
        device_mesh=mesh)
    return core(q, k, v, q_pos, k_pos)


def attention(params, x: torch.Tensor, cfg, *, positions=None,
              compute_dtype, cache: Optional[dict] = None,
              pos: Optional[int] = None, chunked: Optional[bool] = None,
              return_kv: bool = False, kv_pad_to: int = 0
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (train / prefill) or single-token decode attention.

    Train/prefill: ``positions`` (S,) int; returns (y, None) or, with
    ``return_kv``, (y, cache) in :func:`init_cache`'s layout (SWA: rolling
    slots; padded to ``kv_pad_to`` rows when that is longer).
    Decode: ``cache`` = {"k", "v"} (and "k_scale", "v_scale" for int8) of
    (B, S_max, Hk, dh), updated in place; ``pos`` a Python int, the
    current length; x is (B, 1, D).  Returns (y, cache)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, compute_dtype)
    q = constrain_heads(q)
    if cache is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        use_chunked = S > CHUNK_THRESHOLD if chunked is None else chunked
        sdpa = _sdpa_chunked if use_chunked else _sdpa_full
        if isinstance(q, DTensor) and get_mesh() is not None:
            out = _sdpa_on_mesh(sdpa, q, k, v, positions, cfg)
        else:
            out = sdpa(q, k, v, positions, positions, cfg)
        y = gather_unsplit_heads(out.reshape(B, S, -1), cfg.n_heads) \
            @ params["wo"].to(compute_dtype)
        if not return_kv:
            return y, None
        kc, vc = k, v
        W = cfg.swa_window
        if cfg.attention == "swa" and S >= W:
            # decode writes position p at slot p % W: the last W positions
            # S - W + i land at slot (S % W + i) % W, a roll by S % W
            kc = torch.roll(kc[:, -W:], S % W, dims=1)
            vc = torch.roll(vc[:, -W:], S % W, dims=1)
        if kv_pad_to and kv_pad_to > kc.shape[1]:
            pad = (0, 0, 0, 0, 0, kv_pad_to - kc.shape[1])
            kc = torch.nn.functional.pad(kc, pad)
            vc = torch.nn.functional.pad(vc, pad)
        return y, {"k": kc, "v": vc}
    # -- decode ---------------------------------------------------------------
    at = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, at, cfg.rope_theta)
    k = apply_rope(k, at, cfg.rope_theta)
    S_max = cache["k"].shape[1]
    rolling = cfg.attention == "swa" and S_max <= cfg.swa_window
    # dynamic_update_slice clamps the start (attention.py:232-235)
    slot = pos % S_max if rolling else min(pos, S_max - 1)
    if cache["k"].dtype == torch.int8:
        for name, t in (("k", k), ("v", v)):
            codes, scale = _quantize_kv(t)
            cache[name][:, slot].copy_(codes[:, 0])
            cache[name + "_scale"][:, slot].copy_(scale[:, 0])
        kc, vc = (_dequantize_kv(cache[n], cache[n + "_scale"],
                                 compute_dtype) for n in ("k", "v"))
    else:
        cache["k"][:, slot].copy_(k[:, 0])
        cache["v"][:, slot].copy_(v[:, 0])
        # the reference attends over the cache cast to compute_dtype; a
        # cache already in compute_dtype (the server's) is read in place
        kc, vc = (cache[n].to(compute_dtype) for n in ("k", "v"))
    lo = 0
    if cfg.attention == "swa" and not rolling:
        lo = min(max(pos - cfg.swa_window + 1, 0), S_max - 1)
    # a dry run's meta tensors (launch/dryrun.py) take the plain version;
    # on a mesh (only the dry run decodes on one) its heads' grouping needs
    # every head of q on each device
    decode = decode_attention_plain if q.device.type == "meta" \
        else decode_attention
    q = constrain(q, BATCH, None, None, None)
    out = decode(q[:, 0], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3),
                 pos, lo)
    y = out.to(compute_dtype).reshape(B, 1, -1) @ params["wo"].to(
        compute_dtype)
    return y, cache


def init_cache(cfg, batch: int, max_seq: int, dtype, device=None
               ) -> Dict[str, torch.Tensor]:
    """KV cache of zeros, (batch, max_seq, Hk, dh) each, the reference's
    layout; ``max_seq`` capped at the window for sliding-window attention.
    ``dtype=torch.int8`` stores int8 codes with one float16 scale per
    (position, kv head)."""
    dh, Hk = cfg.head_dim_, cfg.n_kv_heads
    if cfg.attention == "swa":
        max_seq = min(max_seq, cfg.swa_window)
    cache = {n: torch.zeros((batch, max_seq, Hk, dh), dtype=dtype,
                            device=device) for n in ("k", "v")}
    if dtype == torch.int8:
        for n in ("k_scale", "v_scale"):
            cache[n] = torch.zeros((batch, max_seq, Hk), dtype=torch.float16,
                                   device=device)
    return cache


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, Hk, dh) -> int8 codes and float16 scales a (pos, head):
    ``max(|x|) / 127`` (at least 1e-6 / 127), codes rounded half to even
    as ``jnp.round`` rounds."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1), min=1e-6) / 127.0
    codes = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(torch.float16)


def _dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype
                   ) -> torch.Tensor:
    return (codes.float() * scale.float()[..., None]).to(dtype)
