"""Partition routing: the port of ``repro/kernels/route.py``.

Counterpart of the Pallas kernel ``route_counts``, its ``route_offsets``
and its oracle (``ref.route_counts_ref``) in one module, plus the route
plan's per-event positions, which the reference computes in ``jnp``
(``streaming/executor.py:189-207``):

* :func:`route_counts` ``(P,)`` int32 ``counts[p] = sum_n valid_n
  [pid_n = p]``; a pid outside ``[0, P)`` counts nowhere;
* :func:`route_offsets` those counts and their exclusive prefix (the
  all-to-all send layout);
* :func:`route_pack` the route plan's counting sort: each event's position
  among the earlier valid events bound for its destination ``key //
  k_loc``, the capacity ``C`` a destination takes from one source, and the
  ``(n_dest, 4, C)`` int32 send buffer (planes: ts, key, the float32
  value's bits, ok), with jnp's index semantics reproduced exactly (see
  :func:`route_pack_plain`);
* ``*_plain``: their plain PyTorch versions (a one-hot sum, and the
  reference's one-hot cumsum).

Dispatch is on the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the hand-written Hopper kernels
(``csrc/route.cu``) or raise.  There is no fallback from one to the other.
Each wrapper counts the launches of its kernel on ``.launches`` (never
plain runs).  ``route_pack`` is one launch: a cluster of 8 blocks holds
the whole counting sort in shared memory (histograms by
``route_counts``' device function, offsets through distributed shared
memory, claims on the send cells), planned by :func:`pack_plan`; it
launches neither ``route_counts`` nor ``route_offsets``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

_INT_MIN = -(2**31)
_TILE = 1024                  # rows a tile of route_pack's blocks
#: route_pack ranks rows by warp votes: one ballot per destination
MAX_DEST = 32
#: route_pack's blocks: one cluster of the portable maximum
CLUSTER_BLOCKS = 8
#: send cells (n_dest x C) whose claims a block of the cluster holds in its
#: shared memory (192 KB of int32); the cluster holds 8 times as many
MAX_CELLS_PER_BLOCK = 49152
#: route_pack's claim holds row << 1, so rows stay below 2^30
MAX_PACK_ROWS = 2**30 - 1
_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the plain counts build one-hot chunks of at most this many entries
_ONEHOT_CHUNK = 2**24


class PackPlan(NamedTuple):
    """How route_pack's cluster splits the work: block ``b`` takes rows
    ``[b * rows_per_block, (b + 1) * rows_per_block)`` (whole 1024-row
    tiles) and the claims of cells ``[b * cells_per_block, (b + 1) *
    cells_per_block)`` of the ``n_dest * C`` send cells, in
    ``smem_bytes`` of dynamic shared memory."""
    blocks: int
    rows_per_block: int
    cells_per_block: int
    smem_bytes: int


def pack_plan(n: int, n_dest: int, cap: int) -> PackPlan:
    """The plan route_pack's kernel runs for ``n`` rows (the kernel's CPU
    mirror).  Raises ``ValueError`` where the claims of ``n_dest * cap``
    cells exceed the cluster's shared memory, or the rows exceed what a
    claim can name."""
    cells = n_dest * cap
    if cells > CLUSTER_BLOCKS * MAX_CELLS_PER_BLOCK:
        raise ValueError(
            f"route_pack holds the claims of n_dest x C = {n_dest} x {cap} "
            f"= {cells} send cells in one cluster's shared memory: at most "
            f"{CLUSTER_BLOCKS} x {MAX_CELLS_PER_BLOCK} = "
            f"{CLUSTER_BLOCKS * MAX_CELLS_PER_BLOCK} cells")
    if n > MAX_PACK_ROWS:
        raise ValueError(f"route_pack takes at most {MAX_PACK_ROWS} rows, "
                         f"got {n}")
    tiles = -(-n // _TILE)
    rows = -(-tiles // CLUSTER_BLOCKS) * _TILE
    per_block = -(-cells // CLUSTER_BLOCKS)
    return PackPlan(CLUSTER_BLOCKS, rows, per_block, per_block * 4)


class RoutePack(NamedTuple):
    """``send`` (n_dest, 4, C) int32 planes ts, key, value bits, ok;
    ``pos`` (N,) int32, each event's position (``INT_MIN`` where the
    reference's column lookup reads its fill), or None where the caller
    did not ask for it; ``n_overflow`` () int32, valid events beyond their
    destination's capacity."""
    send: torch.Tensor
    pos: Optional[torch.Tensor]
    n_overflow: torch.Tensor


def _check_rows(named) -> int:
    """``(name, tensor, dtype or None)`` rows: all 1-D of one length, on
    the first's device, of their dtype.  Returns the length."""
    first = named[0][1]
    n = first.shape[0] if first.dim() == 1 else -1
    for name, t, dtype in named:
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be 1-D of the length of "
                             f"{named[0][0]}, got shape {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, not {first.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if n >= 2**31:
        raise ValueError(f"{n} rows: row indices must fit int32")
    return n


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cuda"


# -- plain versions ------------------------------------------------------------

def route_counts_plain(pids, valid, n_partitions: int) -> torch.Tensor:
    """One-hot sum, as ``ref.route_counts_ref``, in row chunks so that no
    one-hot matrix exceeds 2^24 entries."""
    parts = torch.arange(n_partitions, dtype=torch.int32, device=pids.device)
    p = torch.where(valid, pids, -1)
    counts = torch.zeros(n_partitions, dtype=torch.int32, device=pids.device)
    chunk = max(1, _ONEHOT_CHUNK // n_partitions)
    for s in range(0, p.shape[0], chunk):
        counts += (p[s:s + chunk, None] == parts).sum(0, dtype=torch.int32)
    return counts


def route_offsets_plain(pids, valid, n_partitions: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    counts = route_counts_plain(pids, valid, n_partitions)
    return counts, torch.cumsum(counts, 0, dtype=torch.int32) - counts


def route_pack_plain(ts, key, value, valid, n_dest: int, k_loc: int,
                     cap: int) -> RoutePack:
    """The reference's route layout (executor.py:187-207), in PyTorch.

    ``dest = where(valid, key // k_loc, n)``; ``pos`` is the exclusive
    one-hot cumsum read at column ``min(dest, n - 1)``, a negative column
    wrapped once by ``n`` (jnp.take_along_axis) and one still outside
    reading the fill ``INT_MIN``; ``keep = valid & (pos < C)``.  Every row
    then targets cell ``(d, p) = (keep ? dest : n - 1, min(pos, C - 1))``,
    each index wrapped once if negative and dropped if still outside, and
    ``.at[d, p].set`` writes the row's fields if kept, else zeros.  Where
    rows share a cell the last row in order wins, as jnp's scatter resolves
    it on the CPU (so a row that keeps nothing can erase a kept event
    there, and does in the reference)."""
    n = key.shape[0]
    dev = key.device
    dest = torch.where(valid, torch.div(key, k_loc, rounding_mode="floor"),
                       n_dest)
    onehot = (dest[:, None] == torch.arange(n_dest, dtype=torch.int32,
                                            device=dev)).to(torch.int32)
    before = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    col = torch.clamp(dest, max=n_dest - 1)
    col = torch.where(col < 0, col + n_dest, col)
    looked = before.gather(1, col.clamp(min=0).long()[:, None])[:, 0]
    pos = torch.where(col >= 0, looked, _INT_MIN)
    keep = valid & (pos < cap)
    n_overflow = (valid & ~keep).sum(dtype=torch.int32)
    d = torch.where(keep, dest, n_dest - 1).long()
    p = torch.clamp(pos, max=cap - 1).long()
    d = torch.where(d < 0, d + n_dest, d)
    p = torch.where(p < 0, p + cap, p)
    inside = (d >= 0) & (d < n_dest) & (p >= 0) & (p < cap)
    # the last row to target each cell wins; cell n_dest * cap is nowhere
    cell = torch.where(inside, d * cap + p, n_dest * cap)
    rows = torch.arange(n, device=dev)
    winner = torch.full((n_dest * cap + 1,), -1, dtype=torch.long,
                        device=dev).scatter_reduce_(0, cell, rows, "amax")
    writes = keep & inside & (winner[cell] == rows)
    # a (n_dest + 1, 4, C) buffer whose last block takes the rows that
    # write nothing; every written cell is written by exactly one row
    base = torch.where(writes, d * 4 * cap + p, n_dest * 4 * cap)
    flat = torch.zeros((n_dest + 1) * 4 * cap, dtype=torch.int32, device=dev)
    planes = (ts, key, value.to(torch.float32).view(torch.int32),
              torch.ones_like(key))
    for j, plane in enumerate(planes):
        flat.index_put_((base + j * cap,), plane)
    send = flat[:n_dest * 4 * cap].view(n_dest, 4, cap)
    return RoutePack(send, pos, n_overflow)


# -- kernels -----------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("route")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.route_counts_launch.argtypes = [vp, vp, ll, i, vp, i, vp]
    lib.route_scan_launch.argtypes = [vp, vp, ll, i, vp]
    lib.route_pack_launch.argtypes = [vp, vp, vp, i, vp, ll, i, i, i, ll, i,
                                      vp, vp, vp, i, vp]
    ip = ctypes.POINTER(ctypes.c_int)
    lib.route_pack_cluster.argtypes = [i, ip, ip, ip, i]
    for fn in (lib.route_counts_launch, lib.route_scan_launch,
               lib.route_pack_launch, lib.route_pack_cluster):
        fn.restype = ctypes.c_int
    lib.route_error_string.argtypes = [ctypes.c_int]
    lib.route_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        why = _lib().route_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({why})")


def _stream(t: torch.Tensor) -> Tuple[int, int]:
    dev = t.device.index
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def _require_contiguous(named) -> None:
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _counts_kernel(pids, valid, n_partitions: int) -> torch.Tensor:
    counts = torch.zeros(n_partitions, dtype=torch.int32, device=pids.device)
    if pids.shape[0]:
        dev, stream = _stream(pids)
        _raise_on(_lib().route_counts_launch(
            pids.data_ptr(), valid.data_ptr(), pids.shape[0], n_partitions,
            counts.data_ptr(), dev, stream), "route_counts")
        route_counts.launches += 1
    return counts


def _scan_kernel(x: torch.Tensor, out: torch.Tensor) -> None:
    dev, stream = _stream(x)
    _raise_on(_lib().route_scan_launch(x.data_ptr(), out.data_ptr(),
                                       x.numel(), dev, stream),
              "route_offsets")
    route_offsets.launches += 1


def _check_counts_args(pids, valid, n_partitions: int) -> bool:
    _check_rows((("pids", pids, torch.int32), ("valid", valid, torch.bool)))
    if n_partitions < 1:
        raise ValueError(f"n_partitions must be >= 1, got {n_partitions}")
    cuda = _on_cuda(pids, "route_counts")
    if cuda:
        _require_contiguous((("pids", pids), ("valid", valid)))
    return cuda


def route_counts(pids, valid, n_partitions: int) -> torch.Tensor:
    """pids: (N,) int32; valid: (N,) bool.  Returns (P,) int32 counts; a
    pid outside ``[0, P)`` counts nowhere; ``N == 0`` launches nothing."""
    if not _check_counts_args(pids, valid, n_partitions):
        return route_counts_plain(pids, valid, n_partitions)
    return _counts_kernel(pids, valid, n_partitions)


def route_offsets(pids, valid, n_partitions: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(counts, offsets)``: :func:`route_counts` and its exclusive
    prefix, each (P,) int32."""
    if not _check_counts_args(pids, valid, n_partitions):
        return route_offsets_plain(pids, valid, n_partitions)
    counts = _counts_kernel(pids, valid, n_partitions)
    offsets = torch.zeros_like(counts)
    if pids.shape[0]:
        _scan_kernel(counts, offsets)
    return counts, offsets


def route_pack(ts, key, value, valid, n_dest: int, k_loc: int,
               cap: int, *, with_pos: bool = True) -> RoutePack:
    """The route plan's send layout for one shard's slice of a batch: ts,
    key (int32), value (float; packed as float32 bits), valid (bool), all
    (N,); ``n_dest`` destinations (1 to 32) owning ``k_loc`` key buckets
    each, ``cap`` cells per destination.  See :func:`route_pack_plain` for
    the exact semantics.  On a card: one launch (``N == 0`` launches
    nothing); ``ValueError`` where :func:`pack_plan` cannot hold the
    cells.  ``with_pos=False`` returns ``pos=None`` and spares the kernel
    the store (the route plan reads only ``send`` and ``n_overflow``)."""
    n = _check_rows((("key", key, torch.int32), ("ts", ts, torch.int32),
                     ("value", value, None), ("valid", valid, torch.bool)))
    if not 1 <= n_dest <= MAX_DEST or k_loc < 1 or cap < 1:
        raise ValueError(f"need 1 <= n_dest <= {MAX_DEST}, k_loc >= 1 and "
                         f"cap >= 1; got {n_dest}, {k_loc}, {cap}")
    if n_dest * 4 * cap >= 2**31:
        raise ValueError(f"send buffer of {n_dest} x 4 x {cap} cells "
                         f"exceeds int32 indexing")
    if not value.is_floating_point():
        raise TypeError(f"value must be floating point, got {value.dtype}")
    if not _on_cuda(key, "route_pack"):
        pack = route_pack_plain(ts, key, value, valid, n_dest, k_loc, cap)
        return pack if with_pos else pack._replace(pos=None)
    if value.dtype not in _VALUE_CODES:
        raise TypeError(f"the kernel reads float32, bfloat16 or float16 "
                        f"values, got {value.dtype}")
    _require_contiguous((("ts", ts), ("key", key), ("value", value),
                         ("valid", valid)))
    plan = pack_plan(n, n_dest, cap)
    dev = key.device
    if n == 0:
        return RoutePack(torch.zeros((n_dest, 4, cap), dtype=torch.int32,
                                     device=dev),
                         torch.empty(0, dtype=torch.int32, device=dev)
                         if with_pos else None,
                         torch.zeros((), dtype=torch.int32, device=dev))
    # one allocation for the outputs, every cell of which the kernel
    # writes: send, then n_overflow, then pos if asked for
    cells = n_dest * 4 * cap
    out = torch.empty(cells + 1 + (n if with_pos else 0), dtype=torch.int32,
                      device=dev)
    send = out[:cells].view(n_dest, 4, cap)
    n_overflow = out[cells]
    pos = out[cells + 1:] if with_pos else None
    index, stream = _stream(key)
    _raise_on(_lib().route_pack_launch(
        ts.data_ptr(), key.data_ptr(), value.data_ptr(),
        _VALUE_CODES[value.dtype], valid.data_ptr(), n, n_dest, k_loc, cap,
        plan.rows_per_block, plan.cells_per_block,
        pos.data_ptr() if with_pos else None, send.data_ptr(), n_overflow.data_ptr(), index, stream), "route_pack")
    route_pack.launches += 1
    return RoutePack(send, pos, n_overflow)


def pack_cluster(cells_per_block: int, device_index: int
                 ) -> Tuple[int, int, int]:
    """``(blocks, threads a block, clusters the card holds at once)`` of
    route_pack's launch with ``cells_per_block`` claims a block, from the
    CUDA runtime's occupancy query."""
    blocks, threads, clusters = (ctypes.c_int() for _ in range(3))
    _raise_on(_lib().route_pack_cluster(
        cells_per_block, ctypes.byref(blocks), ctypes.byref(threads),
        ctypes.byref(clusters), device_index), "route_pack occupancy")
    return blocks.value, threads.value, clusters.value


route_counts.launches = 0
route_offsets.launches = 0
route_pack.launches = 0
