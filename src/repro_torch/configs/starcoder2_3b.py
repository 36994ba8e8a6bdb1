"""StarCoder2-3B [arXiv:2402.19173; hf]. GQA kv=2, RoPE, LN+bias, gelu."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    norm="ln",
    act="gelu",
    qkv_bias=True,
    mlp_bias=True,
    attn_out_bias=True,
    tie_embeddings=True,
    rope_style="full",
    rope_theta=100000.0,
)
