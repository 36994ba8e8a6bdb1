"""Qwen2-VL-2B backbone [arXiv:2409.12191; hf]. Vision frontend stubbed
(patch embeds replace the prompt's prefix)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    norm="rms",
    act="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_style="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # temporal/height/width half-dim sections
)
