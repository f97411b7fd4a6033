"""Mixture-of-Experts FFN: top-k routing with per-expert capacity
(GShard/Switch-style token dropping).

The port of ``repro/models/moe.py``, with its two paths:

* **no mesh registered, or plain tensors** (one process): dense
  gather/scatter dispatch over the global token set
  (``moe.py:35-107``): routing, one scatter into ``(E, C, D)`` expert
  slots, the experts' SwiGLU as batched products, the combine weighted by
  the renormalised gates.
* **a mesh with a ``"model"`` axis registered and DTensor inputs**
  (``moe.py:114-194``): :func:`_moe_sharded`, the reference's
  ``shard_map`` written with ``local_map``.  Each batch shard routes its
  own tokens with its own capacity ``capacity(T_local)``.  Experts shard
  on ``model``: expert-parallel when ``E % model == 0`` (the rank's first
  expert is its coordinate on ``model`` times ``E // model``), otherwise
  tensor-parallel inside every expert on the ffn dim.  Expert weights not
  in bf16 (FSDP) are gathered over ``data`` just before use, the partial
  outputs are summed over ``model``, and the aux loss is averaged over the
  batch axes.

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
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ..sharding import constraints
from ..sharding.collectives import gather_over, sum_over
from ..sharding.rules import batch_axes, mesh_shape, to_placements
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


def _moe_sharded(params, x: torch.Tensor, cfg, compute_dtype, mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` path (``moe.py:114-187``) over
    ``mesh``, with ``local_map``: ``x`` and the parameters are DTensors,
    redistributed to the reference's in-specs; each rank runs
    :func:`_route` and the experts on its local tokens and experts.

    Gradients follow sum semantics: every input's gradient is ``Partial``
    on the mesh dimensions it is replicated over, and the cotangent of an
    output replicated over ranks that each computed it whole is divided
    by their number (``y`` over the batch axes when the batch does not
    shard; the aux loss over ``model`` and the batch axes).  The FSDP
    gather's backward reduce-scatters over ``data``, so those weights'
    gradients arrive as their shards."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    ms = mesh_shape(mesh)
    msize = ms["model"]
    ep = E % msize == 0                       # expert-parallel feasible?
    # serving weights are bf16 and model-sharded only: no FSDP gathers
    fsdp = params["w_gate"].dtype != torch.bfloat16
    batch = batch_axes(ms)
    n_batch = 1
    for a in batch:
        n_batch *= ms[a]
    b_ok = B % n_batch == 0 and B >= n_batch
    x_spec = (batch if b_ok else None, None, None)
    dsh = "data" if fsdp else None
    if ep:
        w1_spec = w3_spec = w2_spec = ("model", dsh, None)
    else:
        w1_spec = w3_spec = (None, dsh, "model")
        w2_spec = (None, "model", dsh)
    specs = ((None, None), w1_spec, w3_spec, w2_spec, x_spec)
    in_pl = tuple(to_placements(mesh, sp) for sp in specs)
    names = list(ms)

    def grad_pl(placements, gathered):
        return tuple(Partial() if isinstance(p, Replicate)
                     and names[i] not in gathered else p
                     for i, p in enumerate(placements))

    w_gathered = ("data",) if fsdp else ()
    in_grad = (grad_pl(in_pl[0], ()), *(grad_pl(p, w_gathered)
                                        for p in in_pl[1:4]),
               grad_pl(in_pl[4], ()))
    model_group = mesh.get_group("model")
    batch_groups = [mesh.get_group(a) for a in batch]
    first = mesh.get_local_rank("model") * (E // msize) if ep else 0
    y_scale = 1.0 if b_ok else 1.0 / n_batch
    aux_scale = 1.0 / (n_batch * msize)

    def local(router, w1, w3, w2, xb):
        Bl, Sl, _ = xb.shape
        T = Bl * Sl
        C = capacity(T, cfg)
        xt = xb.reshape(T, D).to(compute_dtype)
        gates, expert_idx, flat_e, pos_c, keep, probs = _route(
            xt, router, cfg, C)
        token_of = torch.arange(T * K, device=xb.device) // K
        if fsdp:   # materialize the full D / F dims just before use
            w1 = gather_over(w1, mesh.get_group("data"), 1)
            w3 = gather_over(w3, mesh.get_group("data"), 1)
            w2 = gather_over(w2, mesh.get_group("data"),
                                   1 if ep else 2)
        if ep:
            E_loc = E // msize
            el = flat_e - first
            mine = (el >= 0) & (el < E_loc) & keep
            e_c = torch.clamp(el, 0, E_loc - 1)
        else:
            E_loc, mine, e_c = E, keep, flat_e
        contrib = xt[token_of] * mine[:, None].to(compute_dtype)
        xe = torch.zeros((E_loc, C, D), dtype=compute_dtype,
                         device=xb.device)
        xe = xe.index_put((e_c, pos_c), contrib, accumulate=True)
        ye = _expert_mlp(xe, w1, w3, w2, compute_dtype)  # TP: partial on F
        wgt = (gates.reshape(-1) * mine).to(compute_dtype)
        y = (ye[e_c, pos_c] * wgt[:, None]).reshape(T, K, D).sum(1)
        y = sum_over(y, [model_group], 1, y_scale)
        aux = sum_over(_aux_loss(probs, expert_idx, E), batch_groups,
                             n_batch, aux_scale)
        return y.reshape(Bl, Sl, D), aux

    f = local_map(local, out_placements=(in_pl[4], to_placements(mesh, ())),
                  in_placements=in_pl, in_grad_placements=in_grad,
                  device_mesh=mesh, redistribute_inputs=True)
    return f(params["router"], params["w_gate"], params["w_up"],
             params["w_down"], x)


def moe_ffn(params, x: torch.Tensor, cfg, compute_dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> ((B, S, D), aux load-balancing loss).  The sharded
    path where a mesh with a ``"model"`` axis is registered and ``x`` is a
    DTensor (``moe.py:189-194``), else the dense one."""
    mesh = constraints.get_mesh()
    if mesh is None or "model" not in mesh_shape(mesh) \
            or not isinstance(x, DTensor):
        return _moe_dense(params, x, cfg, compute_dtype)
    return _moe_sharded(params, x, cfg, compute_dtype, mesh)
