"""GQA flash-decode: the port of ``repro/kernels/decode_attn.py``.

Counterpart of the Pallas kernel, its jit wrapper (``ops.decode_attention``)
and its oracle (``ref.decode_attention_ref``) in one module:

* :func:`decode_attention` has the JAX op's signature: q ``(B, H, dh)``,
  k and v ``(B, Hk, S, dh)`` with ``H = Hk * G``, ``pos`` a Python int;
  each query row attends to the positions ``<= pos`` of its kv head.  It
  returns ``(B, H, dh)`` float32.  k and v may be views with any strides
  as long as the head dimension is contiguous: the model passes its
  ``(B, S, Hk, dh)`` cache permuted, and the kernel reads it in place;
* :func:`decode_attention_plain` is the plain PyTorch version, a port of
  ``decode_attention_ref``.

Dispatch is on the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the hand-written Hopper kernel
(``csrc/decode_attn.cu``: split-KV over tiles of 32 positions staged in
shared memory, then a log-sum-exp combine of the splits) or raise.  There is no fallback from one to the other.
``decode_attention.launches`` counts calls that launched the kernel (one
per call, whether it ran one split or several); plain runs never count.

The kernel scales q by ``dh**-0.5`` as the Pallas kernel does; the plain
version scales the scores as the oracle does.  The kernel takes any S: the
reference's ``S % 512 == 0`` belongs to the TPU tiling, not the function.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head dimension the kernel takes at most (two columns a thread); it must
#: also be a multiple of 4 (the kernel reads shared rows as float4)
MAX_HEAD_DIM = 256
#: fewest positions per split; with fewer, a block's fixed costs dominate
MIN_SPLIT_POSITIONS = 64
#: splits aim at this many blocks per SM
BLOCKS_PER_SM = 2
#: query rows one block holds (csrc/decode_attn.cu kMaxG)
ROWS_PER_BLOCK = 8


def _check(q, k, v, pos) -> int:
    pos = operator.index(pos)
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be (B, H, dh) and k, v (B, Hk, S, dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hk, S = k.shape[1], k.shape[2]
    if Hk == 0 or H % Hk or S == 0:
        raise ValueError(f"{H} query heads over {Hk} kv heads, S = {S}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype must be float32, bfloat16 or float16, got "
                        f"{q.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    return pos


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: int) -> torch.Tensor:
    """Plain version, the port of ``ref.decode_attention_ref``: scores in
    f32 scaled by ``dh**-0.5``, positions above ``pos`` masked with
    ``-1e30``, softmax over all S, then the weighted sum of v."""
    B, H, dh = q.shape
    Hk, S = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.reshape(B, Hk, G, dh).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * (dh ** -0.5)
    mask = torch.arange(S, device=q.device) <= pos
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out.reshape(B, H, dh)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attn")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention_launch.argtypes = [
        P, P, P, I, P, P, P, I, I, I, I, I, I, I, L, L, L, L, L, L, L, L, I,
        P]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(B: int, H: int, Hk: int, n_valid: int, sms: int
               ) -> tuple[int, int]:
    """``(splits, chunk)``: cut the ``n_valid`` positions into splits of
    ``chunk`` (none empty) so that about ``BLOCKS_PER_SM`` blocks run on
    each of ``sms`` SMs, with at least ``MIN_SPLIT_POSITIONS`` a split."""
    g_tiles = -(-(H // Hk) // ROWS_PER_BLOCK)
    base = B * Hk * g_tiles
    want = -(-BLOCKS_PER_SM * sms // base)
    splits = max(1, min(want, n_valid // MIN_SPLIT_POSITIONS))
    chunk = -(-n_valid // splits)
    return -(-n_valid // chunk), chunk


def _launch(q, k, v, pos: int) -> torch.Tensor:
    B, H, dh = q.shape
    Hk, S = k.shape[1], k.shape[2]
    if dh > MAX_HEAD_DIM or dh % 4:
        raise ValueError(f"the kernel takes dh <= {MAX_HEAD_DIM}, a multiple "
                         f"of 4, got {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"(head) dimension, strides {t.stride()}")
    dev = q.device.index
    n_valid = min(pos, S - 1) + 1
    splits, chunk = split_plan(B, H, Hk, n_valid, _sm_count(dev))
    out = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    if splits > 1:
        part_acc = torch.empty((B, H, splits, dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32,
                              device=q.device)
        acc_ptr, ml_ptr = part_acc.data_ptr(), part_ml.data_ptr()
    else:
        acc_ptr = ml_ptr = None
    lib = _lib()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPE_CODES[q.dtype],
        out.data_ptr(), acc_ptr, ml_ptr, B, H, Hk, dh, n_valid, chunk,
        splits, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        why = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} ({why})")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int) -> torch.Tensor:
    """q: (B, H, dh); k, v: (B, Hk, S, dh) views, head dimension
    contiguous; pos: attend to positions ``<= pos`` (all S when
    ``pos >= S``).  Returns (B, H, dh) float32."""
    pos = _check(q, k, v, pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _launch(q, k, v, pos)


decode_attention.launches = 0
