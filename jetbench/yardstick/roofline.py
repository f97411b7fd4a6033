"""The bytes a kernel call needs, counted from its inputs, and its share
of the memory roofline.

A call's bound is its bytes at the card's memory rate (these kernels do a
few integer operations a byte, far under the compute roof): each input
byte read once and each output byte written once, whatever the kernel
reads again; where the work depends on the data, what these inputs need.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S


def accumulate_bytes(rows: int, value_bytes: int, ring_len: int,
                     cells: int) -> int:
    """``accumulate`` (``kernels/window_agg.py::accumulate_``) on ``rows``
    events: ts, key, value and valid read once; ``slot_frame`` read and
    written once; every pane cell the valid events touch read and written
    once (``cells`` distinct (slot, key) pairs); the four int32 scalars
    read and written once."""
    return (rows * (4 + 4 + value_bytes + 1) + 2 * 4 * ring_len + 8 * cells
            + 2 * 4 * 4)


def route_pack_bytes(rows: int, n_dest: int, capacity: int) -> int:
    """``route_pack`` (``kernels/route.py``) on ``rows`` events: ts, key,
    value and valid read once; the ``(n_dest, 4, capacity)`` int32 send
    buffer and the overflow count written once."""
    return rows * (4 + 4 + 4 + 1) + n_dest * 4 * capacity * 4 + 4


def roofline_pct(nbytes: float, device_s: float) -> float:
    """The share, in percent, of the memory roofline that ``nbytes`` moved
    in ``device_s`` seconds of kernel time reach."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
