"""Whisper-small backbone [arXiv:2212.04356], a copy of
``repro.configs.whisper_small``: 12 encoder + 12 decoder layers. The
conv / audio frontend is a stub: the encoder takes precomputed frame
embeddings (``encoder_seq`` of them)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,              # decoder layers
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    norm="ln",
    act="gelu",
    qkv_bias=True,
    mlp_bias=True,
    attn_out_bias=True,
    rope_style="none",        # learned absolute positions
    encoder_seq=1500,
    tie_embeddings=True,
)
