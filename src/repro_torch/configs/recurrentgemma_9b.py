"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427]. RG-LRU + local attn, 1 attn : 2 rec."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="rglru",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,             # MQA for the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    norm="rms",
    act="geglu",
    rope_style="full",
    rope_theta=10000.0,
    rope_fraction=0.5,        # as JAX's copy; 'full' RoPE never reads it
    sliding_window=2048,      # local attention window
    block_pattern=("rec", "rec", "attn"),
    d_rnn=4096,
    conv_width=4,
)
