"""RWKV-6 "Finch" mixer: data-dependent decay linear attention and channel
mix (Peng et al., arXiv:2404.05892).

The port of ``repro/models/rwkv6.py``.  The state a head is a
(head_dim x head_dim) matrix updated multiplicatively by the data-dependent
decay ``w``; the recurrence runs in float32 over time
(:func:`layers.chunked_time_scan`), a single step for decode.  ``w0`` and
the bonus ``u`` are read in float32 whatever the parameters' type.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding.constraints import BATCH, constrain
from .layers import chunked_time_scan, normal_init, placed_zeros

LORA_DIM = 32
DECAY_LORA = 64


def _heads(cfg) -> Tuple[int, int]:
    return cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size


def init_rwkv6(gen: torch.Generator, cfg, dtype, device=None
               ) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    H, dh = _heads(cfg)
    Fd = cfg.d_ff
    s = D ** -0.5

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def normal(shape, scale):
        return normal_init(gen, shape, scale, dtype, device)

    return {
        # time-mix ddlerp
        "maa_x": zeros(D),
        "maa": zeros(5, D),                              # w, k, v, r, g
        "tm_w1": normal((D, 5 * LORA_DIM), s),
        "tm_w2": normal((5, LORA_DIM, D), LORA_DIM ** -0.5),
        # data-dependent decay
        "w0": torch.full((D,), -6.0, dtype=dtype, device=device),
        "td_w1": normal((D, DECAY_LORA), s),
        "td_w2": normal((DECAY_LORA, D), DECAY_LORA ** -0.5),
        "u": normal((H, dh), 0.1),                       # bonus (time_faaaa)
        "wr": normal((D, D), s),
        "wk": normal((D, D), s),
        "wv": normal((D, D), s),
        "wg": normal((D, D), s),
        "wo": normal((D, D), s),
        "ln_x_scale": torch.ones((D,), dtype=dtype, device=device),
        "ln_x_bias": zeros(D),
        # channel-mix
        "cm_maa_k": zeros(D),
        "cm_maa_r": zeros(D),
        "cm_wk": normal((D, Fd), s),
        "cm_wv": normal((Fd, D), Fd ** -0.5),
        "cm_wr": normal((D, D), s),
    }


def _shift(x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """x_{t-1} with ``state`` as the t=-1 input. x: (B, S, D)."""
    if x.shape[1] == 1:
        return state[:, None, :]
    return torch.cat([state[:, None, :], x[:, :-1, :]], dim=1)


def _group_norm(y: torch.Tensor, scale, bias, H: int, eps: float = 1e-5
                ) -> torch.Tensor:
    """Per-head layernorm of (B, S, H*dh), in float32."""
    B, S, D = y.shape
    yh = y.reshape(B, S, H, D // H).float()
    mean = yh.mean(-1, keepdim=True)
    var = ((yh - mean) ** 2).mean(-1, keepdim=True)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return yh.reshape(B, S, D) * scale.float() + bias.float()


def _wkv_step(s: torch.Tensor, r_t, k_t, v_t, w_t, u: torch.Tensor):
    """One step of the wkv recurrence in float32: state (B, H, dh, dh) and
    inputs (B, H, dh) -> (new state, output (B, H, dh))."""
    kv = k_t.float()[..., :, None] * v_t.float()[..., None, :]
    y_t = torch.einsum("bhi,bhij->bhj", r_t.float(), s + u[None, :, :, None]
                       * kv)
    s = w_t.float()[..., None] * s + kv
    return s, y_t


def time_mix(params, x: torch.Tensor, cfg, compute_dtype,
             state: Optional[torch.Tensor] = None,
             shift_state: Optional[torch.Tensor] = None):
    """Returns (y, new_wkv_state, new_shift_state).

    state: (B, H, dh, dh) wkv state; shift_state: (B, D) last input."""
    B, S, D = x.shape
    H, dh = _heads(cfg)
    cd = compute_dtype
    x = x.to(cd)
    if shift_state is None:
        shift_state = torch.zeros((B, D), dtype=cd, device=x.device)
    xx = _shift(x, shift_state.to(cd)) - x
    xxx = x + xx * params["maa_x"].to(cd)
    # on a mesh the lora's 5 x LORA_DIM columns are replicated before the
    # split into 5 (tm_w1 shards them on model, which 5 need not divide)
    lora = constrain(torch.tanh(xxx @ params["tm_w1"].to(cd)),
                     BATCH, None, None).reshape(B, S, 5, LORA_DIM)
    mods = torch.einsum("bsfl,fld->bsfd", lora, params["tm_w2"].to(cd))
    maa = params["maa"].to(cd)                                  # (5, D)
    xw, xk, xv, xr, xg = [x + xx * (maa[i] + mods[:, :, i, :])
                          for i in range(5)]
    w = (params["w0"].float()
         + (torch.tanh(xw @ params["td_w1"].to(cd))
            @ params["td_w2"].to(cd)).float())
    w = torch.exp(-torch.exp(w))                                # (B, S, D)
    r = (xr @ params["wr"].to(cd)).reshape(B, S, H, dh)
    k = (xk @ params["wk"].to(cd)).reshape(B, S, H, dh)
    v = (xv @ params["wv"].to(cd)).reshape(B, S, H, dh)
    g = F.silu(xg @ params["wg"].to(cd))
    u = params["u"].float()                                     # (H, dh)
    wh = w.reshape(B, S, H, dh)

    # on a mesh the recurrence runs per shard: its inputs with the batch
    # on (pod, data) and the heads on model, as the bonus u (no-ops
    # without a mesh)
    r, k, v, wh = (constrain(t, BATCH, None, "model", None)
                   for t in (r, k, v, wh))
    u = constrain(u, "model", None)

    def step(s, inp, u):
        return _wkv_step(s, *inp, u)

    if state is None:
        # (B, H, dh, dh), placed as r's (B, S, H, dh) batch and heads
        state = placed_zeros((B, H, dh, dh), r, {0: 0, 2: 1}, torch.float32)
    if S == 1:
        state, y = step(state, (r[:, 0], k[:, 0], v[:, 0], wh[:, 0]), u)
        y = y[:, None]
    else:
        state, ys = chunked_time_scan(
            step, state, tuple(t.transpose(0, 1) for t in (r, k, v, wh)),
            consts=(u,))
        y = ys.transpose(0, 1)                                  # (B,S,H,dh)
    y = _group_norm(y.reshape(B, S, D), params["ln_x_scale"],
                    params["ln_x_bias"], H)
    y = (y.to(cd) * g) @ params["wo"].to(cd)
    return y, state, x[:, -1, :]


def channel_mix(params, x: torch.Tensor, cfg, compute_dtype,
                shift_state: Optional[torch.Tensor] = None):
    """Returns (y, new_shift_state)."""
    B, S, D = x.shape
    cd = compute_dtype
    x = x.to(cd)
    if shift_state is None:
        shift_state = torch.zeros((B, D), dtype=cd, device=x.device)
    xx = _shift(x, shift_state.to(cd)) - x
    xk = x + xx * params["cm_maa_k"].to(cd)
    xr = x + xx * params["cm_maa_r"].to(cd)
    k = torch.square(F.relu(xk @ params["cm_wk"].to(cd)))
    kv = k @ params["cm_wv"].to(cd)
    y = torch.sigmoid(xr @ params["cm_wr"].to(cd)) * kv
    return y, x[:, -1, :]


def init_rwkv_cache(cfg, batch: int, dtype, device=None
                    ) -> Dict[str, torch.Tensor]:
    H, dh = _heads(cfg)
    D = cfg.d_model
    return {"wkv": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                               device=device),
            "tm_shift": torch.zeros((batch, D), dtype=dtype, device=device),
            "cm_shift": torch.zeros((batch, D), dtype=dtype, device=device)}
