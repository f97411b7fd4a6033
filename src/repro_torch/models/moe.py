"""Mixture-of-Experts FFN: top-k routing with per-expert capacity
(GShard/Switch-style token dropping).

The port of ``repro/models/moe.py``'s dense path (``moe.py:35-107``,
``:189-194``): routing over the global token set, one gather/scatter
dispatch into ``(E, C, D)`` expert slots, the experts' SwiGLU as batched
products, and the combine weighted by the renormalised gates.  The
reference's ``shard_map`` path runs when a mesh is registered; the port
has no mesh layer yet (ROADMAP.md §1, queue item 6), so :func:`moe_ffn`
always runs the dense path.

Types follow the reference: the router is made in float32 whatever the
parameters' type, and its product takes the tokens in the compute type
with float32 sums (``preferred_element_type``); softmax, top-k and the
gates are float32.  ``jax.lax.top_k`` returns equal values lowest index
first; ``torch.topk`` does not promise an order (on the CPU it picked the
highest experts of a uniform row), so the top k come from a stable
descending sort.  A dropped token's slot index is
clamped to ``C - 1`` and it adds a zero there, so the scatter-add is exact
whatever order it runs in.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import normal_init


def init_moe(gen: torch.Generator, cfg, dtype, device=None
             ) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    Fd = cfg.moe_d_ff or cfg.d_ff
    E = cfg.n_experts
    s_in, s_out = D ** -0.5, Fd ** -0.5
    return {"router": normal_init(gen, (D, E), s_in, torch.float32, device),
            "w_gate": normal_init(gen, (E, D, Fd), s_in, dtype, device),
            "w_up": normal_init(gen, (E, D, Fd), s_in, dtype, device),
            "w_down": normal_init(gen, (E, Fd, D), s_out, dtype, device)}


def capacity(n_tokens: int, cfg) -> int:
    """Slots an expert: ``T * k * capacity_factor / E``, at least 8, padded
    to a multiple of 8."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _route(xt: torch.Tensor, router: torch.Tensor, cfg, C: int):
    """Returns ``(gates, expert_idx, flat_e, pos_c, keep, probs)``: the
    renormalised top-k gates (T, K) and experts (T, K), the experts
    flattened token-major (T*K,), each choice's slot in its expert
    (clamped to ``C - 1``), whether it fits, and the softmax (T, E)."""
    E, K = cfg.n_experts, cfg.top_k
    logits = xt.float() @ router.to(xt.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :K], expert_idx[:, :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    flat_e = expert_idx.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    pos_in_e = onehot.cumsum(0) - onehot
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    return (gate_vals, expert_idx, flat_e, torch.clamp(pos, max=C - 1),
            keep, probs)


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor, E: int
              ) -> torch.Tensor:
    """Load-balancing loss: ``E * sum_e f_e * p_e`` with ``f_e`` the mean
    count of choices of expert e a token and ``p_e`` its mean probability."""
    f_e = F.one_hot(expert_idx, E).float().sum(1).mean(0)
    p_e = probs.mean(0)
    return E * (f_e * p_e).sum()


def _expert_mlp(xe, w1, w3, w2, compute_dtype) -> torch.Tensor:
    """Every expert's SwiGLU over its slots: ``(E, C, D)`` in and out."""
    h = (F.silu(torch.bmm(xe, w1.to(compute_dtype)))
         * torch.bmm(xe, w3.to(compute_dtype)))
    return torch.bmm(h, w2.to(compute_dtype))


def _moe_dense(params, x: torch.Tensor, cfg, compute_dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(T, cfg)
    xt = x.reshape(T, D).to(compute_dtype)
    gates, expert_idx, flat_e, pos_c, keep, probs = _route(
        xt, params["router"], cfg, C)
    token_of = torch.arange(T * K, device=x.device) // K
    contrib = xt[token_of] * keep[:, None].to(compute_dtype)
    xe = torch.zeros((E, C, D), dtype=compute_dtype, device=x.device)
    xe.index_put_((flat_e, pos_c), contrib, accumulate=True)
    ye = _expert_mlp(xe, params["w_gate"], params["w_up"],
                     params["w_down"], compute_dtype)
    y_slots = ye[flat_e, pos_c]
    w = (gates.reshape(-1) * keep).to(compute_dtype)
    y = (y_slots * w[:, None]).reshape(T, K, D).sum(1)
    return y.reshape(B, S, D), _aux_loss(probs, expert_idx, E)


def moe_ffn(params, x: torch.Tensor, cfg, compute_dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> ((B, S, D), aux load-balancing loss).  The dense
    path: the reference's ``shard_map`` path needs a mesh, which the port
    does not have yet (ROADMAP.md §1, queue item 6)."""
    return _moe_dense(params, x, cfg, compute_dtype)
