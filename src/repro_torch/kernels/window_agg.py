"""Keyed pane aggregation: the port of ``repro/kernels/window_agg.py``.

Counterpart of the Pallas kernel, its jit wrapper (``ops.window_agg``)
and its oracle (``ref.window_agg_ref``) in one module:

* :func:`window_agg` has the JAX op's signature and returns ``(K, R)``
  float32 sums ``out[k, r] = sum_n valid_n [key_n=k] [slot_n=r] value_n``;
* :func:`window_agg_into_` adds the same sums in place into an ``(R, K)``
  pane matrix, the layout of the executor's state — what ``accumulate``
  calls on the main path;
* :func:`window_agg_plain_into_` is the plain PyTorch version.

Dispatch is on the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the hand-written Hopper kernel
(``csrc/window_agg.cu``) or raise.  There is no fallback from one to the
other.  ``window_agg.launches`` counts kernel launches (never plain runs).

Rows whose key or slot lies outside ``[0, K)`` / ``[0, R)`` contribute
nothing, as in the TPU kernel, where they match no one-hot column.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.window_agg_launch.restype = ctypes.c_int
    lib.window_agg_error_string.argtypes = [ctypes.c_int]
    lib.window_agg_error_string.restype = ctypes.c_char_p
    return lib


def _launch(out: torch.Tensor, keys, slots, values, valid, n_keys: int,
            ring_len: int, stride_slot: int, stride_key: int) -> None:
    n = keys.shape[0]
    if n == 0:
        return
    lib = _lib()
    dev = out.device.index
    err = lib.window_agg_launch(
        keys.data_ptr(), slots.data_ptr(), values.data_ptr(),
        _VALUE_CODES[values.dtype], valid.data_ptr(), out.data_ptr(), n,
        n_keys, ring_len, stride_slot, stride_key, dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        why = lib.window_agg_error_string(err).decode()
        raise RuntimeError(f"window_agg kernel launch failed: CUDA error "
                           f"{err} ({why})")
    window_agg.launches += 1


def _dispatch(out: torch.Tensor, keys, slots, values, valid,
              layout_rk: bool) -> torch.Tensor:
    _check(keys, slots, values, valid)
    if out.device != keys.device:
        raise ValueError(f"output on {out.device}, inputs on {keys.device}")
    if out.dtype != torch.float32 or out.dim() != 2:
        raise TypeError("output must be a 2-D float32 matrix")
    if keys.device.type == "cpu":
        target = out if layout_rk else out.t()
        window_agg_plain_into_(target, keys, slots, values, valid)
        return out
    if keys.device.type != "cuda":
        raise ValueError(f"window_agg runs on cpu or cuda, not "
                         f"{keys.device}")
    for name, t in (("keys", keys), ("slots", slots), ("values", values),
                    ("valid", valid), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if layout_rk:
        R, K = out.shape
        _launch(out, keys, slots, values, valid, K, R, K, 1)
    else:
        K, R = out.shape
        _launch(out, keys, slots, values, valid, K, R, 1, R)
    return out


def window_agg_into_(panes: torch.Tensor, keys, slots, values,
                     valid) -> torch.Tensor:
    """Add the batch into the ``(R, K)`` float32 pane matrix in place
    (the executor's layout); returns ``panes``."""
    return _dispatch(panes, keys, slots, values, valid, layout_rk=True)


def window_agg(keys, slots, values, valid, n_key_buckets: int,
               ring_len: int) -> torch.Tensor:
    """keys/slots: (N,) int32; values: (N,) f32/bf16/f16; valid: (N,) bool.
    Returns the ``(K, R)`` float32 sums; ``N == 0`` gives zeros."""
    out = torch.zeros((n_key_buckets, ring_len), dtype=torch.float32,
                      device=keys.device)
    return _dispatch(out, keys, slots, values, valid, layout_rk=False)


window_agg.launches = 0
