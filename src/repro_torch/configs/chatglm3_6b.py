"""ChatGLM3-6B [arXiv:2406.12793; hf]. Partial ("2d") rotary 0.5, GQA kv=2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    norm="rms",
    act="swiglu",
    qkv_bias=True,
    rope_style="partial",
    rope_fraction=0.5,
    rope_theta=10000.0,
)
