"""Keyed pane aggregation: the port of ``repro/kernels/window_agg.py``.

Counterpart of the Pallas kernel, its jit wrapper (``ops.window_agg``)
and its oracle (``ref.window_agg_ref``) in one module:

* :func:`window_agg` has the JAX op's signature and returns ``(K, R)``
  float32 sums ``out[k, r] = sum_n valid_n [key_n=k] [slot_n=r] value_n``;
* :func:`window_agg_flat_into_` adds values in place into a flat float32
  vector at a precomputed index, with no slot column — what ``accumulate``
  calls on the main path, with the reference's flat pane index
  ``slot * K + key``;
* :func:`window_agg_plain_into_` and :func:`window_agg_flat_plain_into_`
  are their plain PyTorch versions.

Dispatch is on the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the hand-written Hopper kernel
(``csrc/window_agg.cu``) or raise.  There is no fallback from one to the
other.  ``window_agg.launches`` counts kernel launches (never plain runs).

Rows whose key or slot lies outside ``[0, K)`` / ``[0, R)`` (a flat index
outside the vector) contribute nothing, as in the TPU kernel, where they
match no one-hot column, and as ``mode="drop"`` drops them in the
reference's flat scatter.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(keys, slots, values, valid) -> None:
    """``slots`` may be None (the flat form)."""
    n = keys.shape[0]
    named = (("keys", keys), ("values", values), ("valid", valid))
    if slots is not None:
        named += (("slots", slots),)
    for name, t in named:
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be 1-D of length {n}, "
                             f"got shape {tuple(t.shape)}")
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on "
                             f"{keys.device}")
    if keys.dtype != torch.int32 or (slots is not None
                                     and slots.dtype != torch.int32):
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


def window_agg_flat_plain_into_(flat: torch.Tensor, index, values,
                                valid) -> torch.Tensor:
    """Plain version of the flat form: masked ``index_put_`` into the 1-D
    ``flat``; rows that do not contribute add 0 at index 0."""
    keep = valid & (index >= 0) & (index < flat.shape[0])
    i = torch.where(keep, index, 0).long()
    return flat.index_put_((i,), torch.where(keep, values.float(), 0.0),
                           accumulate=True)


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
        keys.data_ptr(), None if slots is None else slots.data_ptr(),
        values.data_ptr(),
        _VALUE_CODES[values.dtype], valid.data_ptr(), out.data_ptr(), n,
        n_keys, ring_len, stride_slot, stride_key, dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        why = lib.window_agg_error_string(err).decode()
        raise RuntimeError(f"window_agg kernel launch failed: CUDA error "
                           f"{err} ({why})")
    window_agg.launches += 1


def _dispatch(out: torch.Tensor, keys, slots, values, valid) -> torch.Tensor:
    """The op into its ``(K, R)`` output when ``slots`` is given, else the
    flat form into the 1-D ``out``."""
    _check(keys, slots, values, valid)
    if out.device != keys.device:
        raise ValueError(f"output on {out.device}, inputs on {keys.device}")
    if out.dtype != torch.float32 or out.dim() != (1 if slots is None else 2):
        raise TypeError("output must be float32, 1-D for the flat form and "
                        "2-D for the op")
    if keys.device.type == "cpu":
        if slots is None:
            return window_agg_flat_plain_into_(out, keys, values, valid)
        window_agg_plain_into_(out.t(), keys, slots, values, valid)
        return out
    if keys.device.type != "cuda":
        raise ValueError(f"window_agg runs on cpu or cuda, not "
                         f"{keys.device}")
    for name, t in (("keys", keys), ("slots", slots), ("values", values),
                    ("valid", valid), ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if slots is None:
        # an int32 index never reaches past 2^31 - 1, whatever the length
        _launch(out, keys, None, values, valid, min(out.shape[0], 2**31 - 1),
                1, 0, 1)
    else:
        K, R = out.shape
        _launch(out, keys, slots, values, valid, K, R, 1, R)
    return out


def window_agg_flat_into_(flat: torch.Tensor, index, values,
                          valid) -> torch.Tensor:
    """Add ``values`` in place into the 1-D float32 ``flat`` at the int32
    ``index``; a row whose index lies outside ``[0, len(flat))`` adds
    nothing.  Returns ``flat``."""
    return _dispatch(flat, index, None, values, valid)


def window_agg(keys, slots, values, valid, n_key_buckets: int,
               ring_len: int) -> torch.Tensor:
    """keys/slots: (N,) int32; values: (N,) f32/bf16/f16; valid: (N,) bool.
    Returns the ``(K, R)`` float32 sums; ``N == 0`` gives zeros."""
    out = torch.zeros((n_key_buckets, ring_len), dtype=torch.float32,
                      device=keys.device)
    return _dispatch(out, keys, slots, values, valid)


window_agg.launches = 0
