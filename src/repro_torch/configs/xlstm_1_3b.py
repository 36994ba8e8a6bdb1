"""xLSTM-1.3B [arXiv:2405.04517], a copy of ``repro.configs.xlstm_1_3b``:
mLSTM blocks with an sLSTM every 8th block. d_ff=0: the blocks carry their
own up / down projections (mLSTM proj factor 2). 48 blocks = 6 groups of
(7 mLSTM + 1 sLSTM)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=0,               # derived: (proj_factor * d_model) / n_heads
    d_ff=0,
    vocab_size=50304,
    norm="ln",
    act="gelu",
    rope_style="none",
    slstm_every=8,
    mlstm_proj_factor=2.0,
    slstm_heads=4,
)
