"""Mixtral-8x7B [arXiv:2401.04088; hf]. 8 experts top-2, SWA window 4096."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    norm="rms",
    act="swiglu",
    rope_style="full",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
)
