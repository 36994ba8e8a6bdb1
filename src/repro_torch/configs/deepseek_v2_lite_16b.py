"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434; hf].

MLA: kv_lora_rank=512, qk_nope=128, qk_rope=64, v_head=128. MoE: 64 routed
experts top-6 + 2 shared, expert hidden 1408; layer 0 uses a dense FFN
(hidden 10944). The values are ``repro.configs.deepseek_v2_lite_16b``'s.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,            # MLA: per-head K/V reconstructed from c_kv
    head_dim=192,             # qk_nope + qk_rope (reference only)
    d_ff=10944,               # dense FFN used for first_dense_layers
    vocab_size=102400,
    norm="rms",
    act="swiglu",
    rope_style="full",        # applied to the rope sub-dim of MLA
    rope_theta=10000.0,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)
