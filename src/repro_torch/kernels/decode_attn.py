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
version; CUDA tensors launch the hand-written Hopper kernel or raise.
There is no fallback from one to the other.  The kernel
(``csrc/decode_attn.cu``): split-KV, each block a (batch row, kv head,
group of query rows, split of the positions); one producer warp keeps a
ring of k/v tiles in shared memory full with TMA loads through a tensor
map of each cache (cached by pointer, shape, strides and type); four
consumer warps compute, on tensor cores for bf16 and f16 and in IEEE f32
on CUDA cores for f32; the last block of a row group to finish combines
the splits (one launch a call).  ``decode_attention.launches`` counts
calls that launched the kernel; plain runs never count.

The kernel scales the f32 scores by ``dh**-0.5`` (q enters unscaled in
its own type); the plain version scales the scores as the oracle does.
The kernel takes any S: the reference's ``S % 512 == 0`` belongs to the
TPU tiling, not the function.  What TMA cannot describe raises
``ValueError``: rows (``dh`` elements) and the strides of k and v must be
multiples of 16 bytes and their bases 16-byte aligned; k and v may have
different strides (each gets its own tensor map).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import operator
import threading

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head dimension the kernel takes at most; it must also be a multiple of
#: 4 (and of 8 in bf16 and f16: TMA moves rows of a multiple of 16 bytes)
MAX_HEAD_DIM = 256
#: an H100's shared memory: 227 KB a block at most, 228 KB an SM of which
#: the runtime reserves 1 KB a block
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024
#: compute warps a block (csrc/decode_attn.cu kConsumerWarps; + 1 producer)
CONSUMER_WARPS = 4
#: query rows a block (csrc/decode_attn.cu kRows: one mma's N)
ROWS_PER_BLOCK = 8
#: ring bytes a block aims at, up to dh 128 (``__launch_bounds__(160, 2)``:
#: two blocks an SM where the shared memory allows) and above (one)
RING_BYTES = {128: 96 * 1024, 256: 192 * 1024}
MAX_STAGES = 8
#: a wave's fixed cost (launch, q, merge, combine) in stages' worth of
#: time, for the split plan
WAVE_OVERHEAD_STAGES = 2
#: splits at most: the last block keeps a weight a split in the ring
MAX_SPLITS = 512


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """What a block of the kernel holds.  On a card the wrapper plans with
    :func:`card_config`, read from the library; :func:`kernel_config` is the
    same rule read without a card, for the plan's tests."""
    tile: int            # positions a stage
    stages: int          # stages of the ring
    smem_bytes: int      # dynamic shared memory a block asks for
    blocks_per_sm: int   # blocks an SM holds at once (registers, memory;
                         # in the mirror, what the launch bounds and the
                         # shared memory guarantee)


@functools.cache
def kernel_config(dtype: torch.dtype, dh: int) -> KernelConfig:
    """The block the kernel runs for ``dtype`` and head dimension ``dh``,
    as ``csrc/decode_attn.cu`` (``tile_of``, ``stages_of``,
    ``make_layout``, ``__launch_bounds__``) decides it: 64 positions a
    stage (16 a warp: one mma's M in bf16 and f16, two a lane in f32), 32
    in f32 above dh 128; as many stages as fit ``RING_BYTES`` (2 to 8);
    the blocks an SM that ``__launch_bounds__`` (2 up to dh 128, else 1)
    and the shared memory guarantee, which registers may exceed.  The card
    holds it to :func:`card_config` (equal, the blocks exactly at dh 128
    and at least elsewhere)."""
    f32 = dtype == torch.float32
    es = 4 if f32 else 2
    tile, rows = (32 if f32 and dh > 128 else 64), ROWS_PER_BLOCK
    stage = 2 * tile * dh * es                     # k and v tiles
    bound = 128 if dh <= 128 else 256
    stages = max(2, min(MAX_STAGES, RING_BYTES[bound] // stage))
    smem = (stages * stage + 16 * stages           # ring, full and empty
            + 2 * 4 * CONSUMER_WARPS * rows + 16   # warps' max and sum
            + (4 * rows * dh + 4 * tile * rows if f32 else 0)
            + 1024)                                # alignment slack
    by_regs = 2 if bound == 128 else 1
    blocks = min(by_regs, SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK))
    return KernelConfig(tile, stages, smem, blocks)


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
    I, L = ctypes.c_int, ctypes.c_longlong
    lib.decode_attention_launch.argtypes = [ctypes.POINTER(L)]
    lib.decode_attention_launch.restype = I
    lib.decode_attention_error_string.argtypes = [I]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    IP = ctypes.POINTER(I)
    lib.decode_attention_config.argtypes = [I, I, IP, IP, IP]
    lib.decode_attention_config.restype = I
    lib.decode_attention_occupancy.argtypes = [I, I, I, IP, IP, IP]
    lib.decode_attention_occupancy.restype = I
    lib.decode_attention_maps_encoded.argtypes = []
    lib.decode_attention_maps_encoded.restype = L
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def split_plan(B: int, H: int, Hk: int, n_valid: int, sms: int,
               cfg: KernelConfig) -> tuple[int, int]:
    """``(splits, chunk)``: cut the ``n_valid`` positions into splits of
    ``chunk``, a whole number of ``cfg.tile``-position stages (none empty;
    only the last split may be shorter), for blocks of ``cfg`` on ``sms``
    SMs.  The time is taken as the stages the busiest SM runs (its blocks
    times their stages: blocks on one SM share it) plus
    ``WAVE_OVERHEAD_STAGES`` a wave of ``sms * cfg.blocks_per_sm`` blocks;
    the candidates are one split and the most that fill 1 to 8 blocks an
    SM; ties go to fewer splits."""
    g_tiles = -(-(H // Hk) // ROWS_PER_BLOCK)
    base = B * Hk * g_tiles
    slots = sms * cfg.blocks_per_sm
    tiles = min(-(-n_valid // cfg.tile), MAX_SPLITS)
    cands = sorted({1} | {min(tiles, k * sms // base) for k in range(1, 9)}
                   - {0})

    def plan(s):
        chunk = -(-(-(-n_valid // s)) // cfg.tile) * cfg.tile
        return -(-n_valid // chunk), chunk

    def cost(s):
        splits, chunk = plan(s)
        return (-(-base * splits // sms) * (chunk // cfg.tile)
                + WAVE_OVERHEAD_STAGES * -(-base * splits // slots))

    return plan(min(cands, key=cost))


@functools.lru_cache(maxsize=1024)
def _tma_layout_error(shape, k_strides, v_strides, es: int):
    """Why TMA cannot describe k and v of ``shape`` and these strides
    (``es``-byte elements), or None; the bases are checked per call."""
    dh = shape[3]
    if dh * es % 16:
        return (f"TMA moves rows of a multiple of 16 bytes; dh = {dh} of "
                f"{es}-byte elements is {dh * es} bytes")
    for name, strides in (("k", k_strides), ("v", v_strides)):
        for size, stride in zip(shape[:3], strides[:3]):
            if size > 1 and (stride <= 0 or stride * es % 16):
                return (f"TMA needs strides that are positive multiples of "
                        f"16 bytes; {name} has strides {strides} of "
                        f"{es}-byte elements")
    return None


_WORKSPACES: dict = {}


def _workspace(device: torch.device, stream: int, counters: int,
               floats: int) -> tuple[int, int]:
    """``(counters, partials)`` pointers into the workspace of (device,
    stream): ``counters`` int32 arrival counters, zero and left zero by
    every launch (the last block of a row group resets its own), then
    ``floats`` float32 of partials.  Launches on one stream run in order,
    so each reuses it; it is replaced, zeroed, when a call needs more."""
    ent = _WORKSPACES.get((device, stream))
    if ent is None or ent[1] < counters or ent[0].numel() - ent[1] < floats:
        old_c, old_f = (0, 0) if ent is None else (ent[1], ent[0].numel()
                                                   - ent[1])
        c = -(-max(counters, old_c, 1024) // 4) * 4   # partials 16-B aligned
        f = max(floats, 2 * old_f)
        ent = (torch.zeros(c + f, dtype=torch.int32, device=device), c)
        _WORKSPACES[(device, stream)] = ent
    base = ent[0].data_ptr()
    return base, base + 4 * ent[1]


def occupancy(dtype: torch.dtype, dh: int, device_index: int
              ) -> tuple[int, int, int]:
    """``(blocks an SM, registers a thread, spill bytes a thread)`` of the
    kernel for ``dtype`` and ``dh``, from the CUDA runtime."""
    blocks, regs, local = (ctypes.c_int() for _ in range(3))
    err = _lib().decode_attention_occupancy(
        _DTYPE_CODES[dtype], dh, device_index, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"decode_attention occupancy query failed: CUDA "
                           f"error {err}")
    return blocks.value, regs.value, local.value


@functools.cache
def card_config(dtype: torch.dtype, dh: int,
                device_index: int) -> KernelConfig:
    """The block the library runs for ``dtype`` and ``dh`` (its tile,
    stages and shared memory), with the blocks an SM that the card's
    occupancy query reports: what the split plan uses on a card."""
    tile, stages, smem = (ctypes.c_int() for _ in range(3))
    if _lib().decode_attention_config(
            _DTYPE_CODES[dtype], dh, ctypes.byref(tile), ctypes.byref(stages),
            ctypes.byref(smem)) != 0:
        raise ValueError(f"the kernel does not take dh = {dh} in {dtype}")
    blocks = occupancy(dtype, dh, device_index)[0]
    return KernelConfig(tile.value, stages.value, smem.value, blocks)


def maps_encoded() -> int:
    """Tensor maps the library has encoded (the others came from its
    cache)."""
    return _lib().decode_attention_maps_encoded()


_ARGS = threading.local()


def _launch(q, k, v, pos: int) -> torch.Tensor:
    B, H, dh = q.shape
    Hk, S = k.shape[1], k.shape[2]
    if dh > MAX_HEAD_DIM or dh % 4:
        raise ValueError(f"the kernel takes dh <= {MAX_HEAD_DIM}, a multiple "
                         f"of 4, got {dh}")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[2] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError(f"q, k and v must be contiguous in their last "
                         f"(head) dimension, strides {qs}, {ks}, {vs}")
    why = _tma_layout_error(k.shape, ks, vs, k.element_size())
    if why is not None:
        raise ValueError(why)
    k_ptr, v_ptr = k.data_ptr(), v.data_ptr()
    if k_ptr % 16 or v_ptr % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base; k starts at "
                         f"{k_ptr:#x}, v at {v_ptr:#x}")
    dev = q.device.index
    cfg = card_config(q.dtype, dh, dev)
    n_valid = min(pos, S - 1) + 1
    splits, chunk = split_plan(B, H, Hk, n_valid, _sm_count(dev), cfg)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    out = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    counters = ws = 0
    if splits > 1:
        groups = B * Hk * -(-(H // Hk) // ROWS_PER_BLOCK)
        counters, ws = _workspace(q.device, stream, groups,
                                  B * H * splits * (dh + 2))
    args = getattr(_ARGS, "buf", None)
    if args is None:                    # one packed array a thread
        args = _ARGS.buf = (ctypes.c_longlong * 25)()
    args[:] = (q.data_ptr(), k_ptr, v_ptr, _DTYPE_CODES[q.dtype],
               out.data_ptr(), ws, counters, B, H, Hk, S, dh, n_valid, chunk,
               splits, qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
               dev, stream)
    lib = _lib()
    err = lib.decode_attention_launch(args)
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
