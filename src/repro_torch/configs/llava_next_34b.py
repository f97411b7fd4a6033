"""LLaVA-NeXT-34B backbone: dense GQA decoder; the anyres vision tower is
a STUB: input_specs() feeds precomputed patch embeddings
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    norm="rmsnorm", rope_theta=5_000_000.0, modality="vlm_stub",
)
