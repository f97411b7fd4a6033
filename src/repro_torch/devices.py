"""Where the port runs, and how precisely its float32 products run there.

* :func:`resolve_device`: every entry point runs on ``cuda`` unless the
  caller names another device; with no card and no device named it
  raises, rather than run on the CPU unasked.
* :func:`ieee_fp32_matmul`: a float32 matmul on the card may run in TF32
  when the caller switched it on globally.  TF32 keeps 10 mantissa bits:
  a pane sum above 2048 (bid prices, large counts) or a logit summed over
  a 1536-wide row would come out rounded.  The window emission and the LM
  decode step run inside it and so stay IEEE float32 whatever the caller
  set.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device=None, what: str = "it") -> torch.device:
    """``device``, or the current CUDA card when it is None; a CUDA device
    gets its index.  Raises where there is no card and ``device`` is not a
    CPU (``what`` names the caller in the message)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device: {what} runs on the GPU "
                               f"unless it is built with device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def ieee_fp32_matmul() -> Iterator[None]:
    """Run float32 matmuls in full IEEE float32 inside the block, whatever
    the caller's global TF32 setting; the setting is restored after."""
    # ``fp32_precision`` (torch >= 2.9) reads and sets the flag whichever
    # API the caller used; the legacy ``allow_tf32`` raises after the new
    # one was used
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev
