"""Keyed pane aggregation: the port of ``repro/kernels/window_agg.py``, and
the device tier's stage-1 ``accumulate`` that runs on it.

* :func:`window_agg` has the JAX op's signature and returns ``(K, R)``
  float32 sums ``out[k, r] = sum_n valid_n [key_n=k] [slot_n=r] value_n``
  (the counterpart of the Pallas kernel, its jit wrapper ``ops.window_agg``
  and its oracle ``ref.window_agg_ref``); rows whose key or slot lies
  outside ``[0, K)`` / ``[0, R)`` contribute nothing, as in the TPU
  kernel, where they match no one-hot column;
* :func:`accumulate_` is the reference's ``streaming/window.py::
  accumulate`` on a window state, in place: on a card ONE launch of the
  hand-written ``accumulate_kernel`` (lateness, ring conflicts, the pane
  scatter-add, the ``slot_frame`` update, the drop counters and the
  watermark);
* :func:`window_agg_plain_into_` and :func:`accumulate_plain_` are their
  plain PyTorch versions.

Dispatch is on the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the hand-written Hopper kernel
(``csrc/window_agg.cu``) or raise.  There is no fallback from one to the
other.  ``window_agg.launches`` and ``accumulate_.launches`` count each
wrapper's kernel launches (never plain runs).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT32 = (-(2**31), 2**31 - 1)


def _check(keys, slots, values, valid) -> None:
    n = keys.shape[0]
    for name, t in (("keys", keys), ("slots", slots), ("values", values),
                    ("valid", valid)):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be 1-D of length {n}, "
                             f"got shape {tuple(t.shape)}")
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on "
                             f"{keys.device}")
    if keys.dtype != torch.int32 or slots.dtype != torch.int32:
        raise TypeError("keys and slots must be int32")
    if values.dtype not in _VALUE_CODES:
        raise TypeError(f"values must be float32, bfloat16 or float16, "
                        f"got {values.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")


def _require_contiguous(named) -> None:
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def window_agg_plain_into_(out: torch.Tensor, keys, slots, values,
                           valid) -> torch.Tensor:
    """Plain version: masked ``index_put_(accumulate=True)`` into the
    ``(R, K)`` matrix ``out``.  Rows that do not contribute are pointed at
    cell (0, 0) with value 0, so the scatter never leaves bounds (torch
    raises where the reference's ``mode="drop"`` drops) and no boolean
    compaction forces a device sync."""
    R, K = out.shape
    keep = valid & (keys >= 0) & (keys < K) & (slots >= 0) & (slots < R)
    s = torch.where(keep, slots, 0).long()
    k = torch.where(keep, keys, 0).long()
    v = torch.where(keep, values.float(), 0.0)
    return out.index_put_((s, k), v, accumulate=True)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("window_agg")
    lib.window_agg_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.window_agg_launch.restype = ctypes.c_int
    lib.accumulate_launch.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.accumulate_launch.restype = ctypes.c_int
    lib.window_agg_error_string.argtypes = [ctypes.c_int]
    lib.window_agg_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        why = _lib().window_agg_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({why})")


def window_agg(keys, slots, values, valid, n_key_buckets: int,
               ring_len: int) -> torch.Tensor:
    """keys/slots: (N,) int32; values: (N,) f32/bf16/f16; valid: (N,) bool.
    Returns the ``(K, R)`` float32 sums; ``N == 0`` gives zeros."""
    _check(keys, slots, values, valid)
    out = torch.zeros((n_key_buckets, ring_len), dtype=torch.float32,
                      device=keys.device)
    if keys.device.type == "cpu":
        window_agg_plain_into_(out.t(), keys, slots, values, valid)
        return out
    if keys.device.type != "cuda":
        raise ValueError(f"window_agg runs on cpu or cuda, not "
                         f"{keys.device}")
    _require_contiguous((("keys", keys), ("slots", slots),
                         ("values", values), ("valid", valid)))
    n = keys.shape[0]
    if n == 0:
        return out
    dev = keys.device.index
    _raise_on(_lib().window_agg_launch(
        keys.data_ptr(), slots.data_ptr(), values.data_ptr(),
        _VALUE_CODES[values.dtype], valid.data_ptr(), out.data_ptr(), n,
        n_key_buckets, ring_len, dev,
        torch.cuda.current_stream(dev).cuda_stream), "window_agg")
    window_agg.launches += 1
    return out


window_agg.launches = 0


# -- accumulate ----------------------------------------------------------------

_SCALARS = ("watermark", "next_emit", "dropped_late", "dropped_conflict")


def _no_frontier(n: int, frontier_from_data: bool) -> None:
    if n == 0 and frontier_from_data:
        # the reference's jnp.max over no rows raises as well
        raise ValueError("accumulate of no rows has no data-driven "
                         "watermark frontier (a max over no rows)")


def accumulate_plain_(state, ts, key, value, valid, *, slide_ms: int,
                      frames_per_window: int, wm_lag: int = 0,
                      frontier_from_data: bool = True, wm_hint=None):
    """Plain version of :func:`accumulate_`: the reference's
    ``accumulate`` (``window.py:116-162``) in PyTorch ops, in place."""
    panes, slot_frame = state["panes"], state["slot_frame"]
    R, K = panes.shape
    F = frames_per_window
    _no_frontier(ts.shape[0], frontier_from_data)
    frame = (ts // slide_ms).to(torch.int32)
    slot = frame % R                       # floor modulo: always in [0, R)

    # lateness: frames below min_frame have had their last window emitted
    ne = state["next_emit"]
    min_frame = torch.where(ne < 0, -(2**30), ne // slide_ms - F)
    live = valid & (frame >= min_frame)
    n_late = (valid & ~live).sum(dtype=torch.int32)

    # ring-slot conflicts: slot occupied by a DIFFERENT still-live frame
    occupant = slot_frame.index_select(0, slot)
    conflict = live & (occupant >= 0) & (occupant != frame)
    n_conflict = conflict.sum(dtype=torch.int32)
    live = live & ~conflict

    # the reference's flat scatter-add (window.py:140-143): the event goes
    # to int32 index slot*K + key of the (R*K,) panes.  JAX indexing wraps
    # an index in [-R*K, 0) by R*K first, and mode="drop" drops what is
    # still outside [0, R*K); so a key outside [0, K) lands in a
    # neighbouring slot (a negative one in the previous slot, or from slot
    # 0 in slot R-1).  Rows that add nothing add 0 at index 0, so the
    # scatter never leaves bounds and no compaction syncs.
    RK = R * K
    combined = slot * K + key.to(torch.int32)
    combined = torch.where(combined < 0, combined + RK, combined)
    adds = live & (combined >= 0) & (combined < RK)
    panes.view(RK).index_put_(
        (torch.where(adds, combined, 0).long(),),
        torch.where(adds, value.to(torch.float32), 0.0), accumulate=True)

    # record which frame now lives in each touched slot.  The reference
    # scatter-maxes dead rows onto index R and drops them (window.py:147-148);
    # torch's scatter_reduce_ raises there, so dead rows scatter -1 onto
    # their own slot instead — a no-op under max, as slot_frame >= -1
    slot_frame.scatter_reduce_(0, slot.long(), torch.where(live, frame, -1),
                               reduce="amax")

    wm = state["watermark"]
    if frontier_from_data:
        # bounded out-of-orderness: the frontier trails the running-max
        # timestamp by wm_lag, so cross-batch disorder within the
        # allowance is admitted instead of dropped as late
        frontier = torch.where(valid, ts, -1).amax().to(torch.int32) \
            - wm_lag
        wm = torch.maximum(wm, frontier)
    if wm_hint is not None:
        wm = torch.maximum(wm, torch.as_tensor(wm_hint, dtype=torch.int32,
                                               device=wm.device))
    state["watermark"].copy_(wm)
    state["dropped_late"].add_(n_late)
    state["dropped_conflict"].add_(n_conflict)
    return state


_WORKSPACES: dict = {}


def _workspace(device: torch.device, stream: int, ring_len: int) -> int:
    """The accumulate workspace of (device, stream): int32 ``[ticket, ts
    max, slot maxima...]`` for at least ``ring_len`` slots, made once as
    ``[0, INT_MIN, -1, ...]``; every launch leaves it so (its last block
    resets it).  Launches on one stream run in order, so each reuses it;
    it is replaced when a call needs more slots, never freed before a
    launch."""
    ws = _WORKSPACES.get((device, stream))
    if ws is None or ws.numel() < 2 + ring_len:
        ws = torch.full((2 + max(ring_len, 1024),), -1, dtype=torch.int32,
                        device=device)
        ws[0] = 0
        ws[1] = _INT32[0]
        _WORKSPACES[(device, stream)] = ws
    return ws.data_ptr()


def _check_state(state) -> None:
    """The state's tensors as the kernel reads them, on the panes' card."""
    panes, slot_frame = state["panes"], state["slot_frame"]
    dev = panes.device
    if panes.dim() != 2 or panes.dtype != torch.float32:
        raise TypeError("panes must be a 2-D float32 (R, K) matrix")
    R, K = panes.shape
    if R * K >= 2**31:
        raise ValueError(f"({R}, {K}) panes: flat pane indices must fit "
                         f"int32")
    if slot_frame.shape != (R,) or slot_frame.dtype != torch.int32:
        raise TypeError(f"slot_frame must be ({R},) int32")
    named = [("panes", panes), ("slot_frame", slot_frame)]
    for name in _SCALARS:
        t = state[name]
        if t.shape != () or t.dtype != torch.int32:
            raise TypeError(f"{name} must be a 0-d int32 tensor")
        named.append((name, t))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, panes on {dev}")
    _require_contiguous(named)


_ARGS = threading.local()


def accumulate_(state, ts, key, value, valid, *, slide_ms: int,
                frames_per_window: int, wm_lag: int = 0,
                frontier_from_data: bool = True, wm_hint=None):
    """Jet stage 1 on ``state`` (the window state's tensors: panes (R, K)
    float32, slot_frame (R,) int32 and four 0-d int32 scalars), in place:
    ts and key (N,) int32, value (N,) float32, bfloat16 or float16, valid
    (N,) bool.  ``wm_hint``: None, an int, or a 0-d tensor (read on the
    card, never with ``.item()``).  On a card one launch; ``N == 0``
    launches nothing (only the hint can move the watermark then, and a
    data-driven frontier of no rows raises ``ValueError``, as the
    reference's max over no rows does).  Returns ``state``."""
    kw = dict(slide_ms=slide_ms, frames_per_window=frames_per_window,
              wm_lag=wm_lag, frontier_from_data=frontier_from_data,
              wm_hint=wm_hint)
    panes = state["panes"]
    dev = panes.device
    if dev.type == "cpu":
        return accumulate_plain_(state, ts, key, value, valid, **kw)
    if dev.type != "cuda":
        raise ValueError(f"accumulate runs on cpu or cuda, not {dev}")
    n = ts.shape[0]
    for name, t, dtype in (("ts", ts, torch.int32), ("key", key, torch.int32),
                           ("value", value, None),
                           ("valid", valid, torch.bool)):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be 1-D of length {n}, got shape "
                             f"{tuple(t.shape)}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if value.dtype not in _VALUE_CODES:
        raise TypeError(f"value must be float32, bfloat16 or float16, got "
                        f"{value.dtype}")
    _check_state(state)
    rows = (("ts", ts), ("key", key), ("value", value), ("valid", valid))
    for name, t in rows:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the state on {dev}")
    _require_contiguous(rows)
    R, K = panes.shape
    hint_ptr = hint_value = 0
    hint_keep = None
    if isinstance(wm_hint, torch.Tensor) and wm_hint.device.type == "cuda":
        hint_keep = torch.as_tensor(wm_hint, dtype=torch.int32, device=dev)
        if hint_keep.numel() != 1:
            raise ValueError("wm_hint must be a scalar")
        hint_ptr = hint_keep.data_ptr()
    elif wm_hint is not None:
        hint_value = int(wm_hint)
        if not _INT32[0] <= hint_value <= _INT32[1]:
            raise ValueError(f"wm_hint {hint_value} does not fit int32")
    _no_frontier(n, frontier_from_data)
    if n == 0:
        if wm_hint is not None:
            wm = state["watermark"]
            wm.copy_(torch.maximum(wm, hint_keep if hint_keep is not None
                                   else torch.tensor(hint_value,
                                                     dtype=torch.int32,
                                                     device=dev)))
        return state
    index = dev.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = getattr(_ARGS, "buf", None)
    if args is None:                    # one packed array a thread
        args = _ARGS.buf = (ctypes.c_longlong * 24)()
    args[:] = (ts.data_ptr(), key.data_ptr(), value.data_ptr(),
               _VALUE_CODES[value.dtype], valid.data_ptr(), n,
               panes.data_ptr(), state["slot_frame"].data_ptr(),
               state["watermark"].data_ptr(), state["next_emit"].data_ptr(),
               state["dropped_late"].data_ptr(),
               state["dropped_conflict"].data_ptr(),
               _workspace(dev, stream, R), hint_ptr, hint_value,
               int(wm_hint is not None), K, R, frames_per_window, slide_ms,
               wm_lag, int(frontier_from_data), index, stream)
    _raise_on(_lib().accumulate_launch(args), "accumulate")
    accumulate_.launches += 1
    return state


accumulate_.launches = 0
