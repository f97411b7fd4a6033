"""RWKV-6 (Finch) 7B: attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", ssm_kind="rwkv6",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=14336, vocab_size=65536,
    norm="layernorm", rwkv_head_size=64,
)
