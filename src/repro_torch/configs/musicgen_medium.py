"""MusicGen-medium: decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf].  The EnCodec frontend is a STUB: input_specs()
feeds precomputed frame token ids (vocab 2048)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="dense",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    norm="layernorm", modality="audio_stub",
)
