"""Model zoo, ported to PyTorch: the dense, MoE, SSM (RWKV-6) and hybrid
(Jamba: Mamba and attention) families of the registry, with the
full-sequence forward and prefill, and single-token decode against KV and
recurrent caches (``lm.make_serve_step``).  ``convert`` carries parameters
and caches across from the JAX package."""

from .config import ModelConfig
from . import lm

__all__ = ["ModelConfig", "lm"]
