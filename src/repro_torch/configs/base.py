"""Model configuration: the subset of ``repro.configs.base`` that the
ported families (dense, rglru) read.

Only the fields those families read are kept; the other families are not
ported yet (``ROADMAP.md`` Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    norm: str = "rms"                 # only 'rms' is ported
    act: str = "swiglu"               # 'swiglu' | 'geglu'  ('gelu' not ported)
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False

    rope_style: str = "full"          # only 'full' is ported
    rope_theta: float = 10000.0

    sliding_window: int = 0           # >0: local attention (rglru)
    n_experts: int = 0

    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ('rec', 'rec', 'attn')
    d_rnn: int = 0
    conv_width: int = 4


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (the dense and rglru branches
    of ``repro.configs.base.reduced``)."""
    upd = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.block_pattern:
        upd["n_layers"] = len(cfg.block_pattern)  # one full pattern group
        upd["d_rnn"] = 128
    if cfg.sliding_window:
        upd["sliding_window"] = 32
    return replace(cfg, name=cfg.name + "-reduced", **upd)
