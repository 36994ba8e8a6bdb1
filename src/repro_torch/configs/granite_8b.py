"""Granite-8B-Code [arXiv:2405.04324; hf]. Llama-arch."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    norm="rms",
    act="swiglu",
    rope_style="full",
    rope_theta=10_000_000.0,
)
