"""Model zoo, ported to PyTorch: so far the dense GQA decoder, for
single-token decode against a KV cache (``lm.make_serve_step``).  MoE,
RWKV-6, Mamba, hybrids and the full-sequence forward are still to port
(ROADMAP.md §1, queue item 2).  ``convert`` carries parameters and caches
across from the JAX package."""

from .config import ModelConfig
from . import lm

__all__ = ["ModelConfig", "lm"]
