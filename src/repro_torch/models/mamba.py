"""Mamba selective SSM mixer (Jamba's recurrent layer).

The port of ``repro/models/mamba.py``.  Training/prefill runs the
recurrence over time (:func:`layers.chunked_time_scan`); decode is a
single-step state update that writes the new state into the cache in
place.  The scan runs in float32, with ``A_log`` and ``D`` read in float32
whatever the parameters' type (``mamba.py:76-77``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding.constraints import BATCH, constrain
from .layers import chunked_time_scan, normal_init, placed_zeros


def _dims(cfg) -> Tuple[int, int]:
    di = cfg.expand * cfg.d_model
    dt_rank = max(1, di // 16)
    return di, dt_rank


def init_mamba(gen: torch.Generator, cfg, dtype, device=None
               ) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    di, R = _dims(cfg)
    N, Kc = cfg.d_state, cfg.d_conv
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": normal_init(gen, (D, 2 * di), D ** -0.5, dtype, device),
        "conv_w": normal_init(gen, (di, Kc), Kc ** -0.5, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": normal_init(gen, (di, R + 2 * N), di ** -0.5, dtype,
                              device),
        "dt_proj": normal_init(gen, (R, di), R ** -0.5, dtype, device),
        # softplus(-4.6) ~ 0.01
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(a).expand(di, N).to(dtype).contiguous(),
        "D": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": normal_init(gen, (di, D), di ** -0.5, dtype, device),
    }


def _ssm_inputs(params, x: torch.Tensor, cfg, compute_dtype,
                conv_state: Optional[torch.Tensor] = None):
    """Shared projections. x: (B, S, D) -> (xc, z, dt, Bs, Cs, new_conv),
    ``new_conv`` the last ``Kc - 1`` inputs of the conv, (B, Kc-1, di)."""
    S = x.shape[1]
    _, R = _dims(cfg)
    N, Kc = cfg.d_state, cfg.d_conv
    xz = x.to(compute_dtype) @ params["in_proj"].to(compute_dtype)
    # on a mesh, the channels shard on model and the batch on (pod, data)
    # at each product's output (no-ops without one)
    xs, z = (constrain(t, BATCH, None, "model")
             for t in xz.chunk(2, dim=-1))                # (B, S, di)
    # causal depthwise conv of width Kc
    if conv_state is None:
        xp = F.pad(xs, (0, 0, Kc - 1, 0))
    else:
        xp = torch.cat([conv_state.to(compute_dtype), xs], dim=1)
    w = params["conv_w"].to(compute_dtype)
    conv = xp[:, 0:S, :] * w[:, 0]
    for k in range(1, Kc):
        conv = conv + xp[:, k:k + S, :] * w[:, k]
    conv = conv + params["conv_b"].to(compute_dtype)
    new_conv = xp[:, -(Kc - 1):, :] if Kc > 1 else None
    xc = F.silu(conv)
    proj = constrain(xc @ params["x_proj"].to(compute_dtype),
                     BATCH, None, None)
    dt, Bs, Cs = proj.split([R, N, N], dim=-1)
    dt = constrain(dt @ params["dt_proj"].to(compute_dtype),
                   BATCH, None, "model")
    dt = F.softplus(dt + params["dt_bias"].to(compute_dtype))
    return xc, z, dt, Bs, Cs, new_conv


def _ssm_step(h: torch.Tensor, xc_t, dt_t, B_t, C_t, A: torch.Tensor):
    """One step of the selective scan in float32: the new state
    (B, di, N) and the output (B, di)."""
    dt32 = dt_t.float()
    dA = torch.exp(dt32[..., None] * A)                   # (B, di, N)
    dBx = (dt32 * xc_t.float())[..., None] * B_t.float()[:, None, :]
    h = h * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, C_t.float())
    return h, y


def mamba(params, x: torch.Tensor, cfg, compute_dtype,
          cache: Optional[dict] = None, return_state: bool = False
          ) -> Tuple[torch.Tensor, Optional[dict]]:
    """cache = {"h": (B, di, N) float32, "conv": (B, Kc-1, di)} for decode,
    updated in place; ``return_state`` (prefill) returns the final state in
    the cache's layout."""
    A = -torch.exp(params["A_log"].float())                # (di, N)
    D_skip = params["D"].float()

    if cache is None:
        B = x.shape[0]
        xc, z, dt, Bs, Cs, conv_tail = _ssm_inputs(params, x, cfg,
                                                   compute_dtype)

        def step(h, inp, A):
            return _ssm_step(h, *inp, A)

        # (B, di, N), placed as xc's (B, S, di) batch and channels
        h0 = placed_zeros((B, cfg.expand * cfg.d_model, cfg.d_state), xc,
                          {0: 0, 2: 1}, torch.float32)
        h_last, ys = chunked_time_scan(
            step, h0, tuple(t.transpose(0, 1) for t in (xc, dt, Bs, Cs)),
            consts=(A,))
        y = ys.transpose(0, 1)                             # (B, S, di)
        y = y + xc.float() * D_skip
        y = (y * F.silu(z.float())).to(compute_dtype)
        out = y @ params["out_proj"].to(compute_dtype)
        if return_state:
            # conv_tail is a view of the whole padded input: a copy lets
            # that go (F12)
            return out, {"h": h_last, "conv": conv_tail.clone()}
        return out, None

    # -- decode: single step --------------------------------------------------
    xc, z, dt, Bs, Cs, new_conv = _ssm_inputs(
        params, x, cfg, compute_dtype, conv_state=cache["conv"])
    h, y = _ssm_step(cache["h"].float(), xc[:, 0], dt[:, 0], Bs[:, 0],
                     Cs[:, 0], A)
    y = y + xc[:, 0].float() * D_skip
    y = (y * F.silu(z[:, 0].float()))[:, None, :]
    y = y.to(compute_dtype) @ params["out_proj"].to(compute_dtype)
    cache["h"].copy_(h)
    cache["conv"].copy_(new_conv)
    return y, cache


def init_mamba_cache(cfg, batch: int, dtype, device=None
                     ) -> Dict[str, torch.Tensor]:
    di, _ = _dims(cfg)
    return {"h": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                                device=device)}
