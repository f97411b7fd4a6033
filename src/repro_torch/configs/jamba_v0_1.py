"""Jamba-v0.1 52B: Mamba+attention 1:7 interleave, 16-expert top-2 MoE
every other layer [arXiv:2403.19887; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2,
    attn_period=8, ssm_kind="mamba", d_state=16, d_conv=4, expand=2,
    norm="rmsnorm",
)
