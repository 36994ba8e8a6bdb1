"""The paper's own expert/router base: Llama2-7B-class (SN40L §II)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="samba-coe-expert-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    norm="rms",
    act="swiglu",
    rope_style="full",
    rope_theta=10000.0,
)
