"""Model configuration: the subset of ``repro.configs.base`` that the
port's families (dense, moe, mla_moe, encdec, rglru, xlstm) read.

Every family of the JAX package is ported; only the fields the families
read are kept (JAX's ``attn_chunk``, ``attn_logit_softcap`` and ``dtype``
steer its XLA lowering, which the port does not have). The MoE fields are
JAX's, ``first_dense_layers`` included (DeepSeek's dense head layers), and
so are the MLA, encoder-decoder (Whisper) and xLSTM fields. The expert
capacity is ``capacity_factor``: the port has no run-time override of it.

The dry-run's supports are JAX's too: the derived dims and predicates
(``kv_dim``, ``attention_free``, ``sub_quadratic``, ``has_decode``), the
parameter counts (from the port's own ``param_specs``, the same leaves as
JAX's), the four ``SHAPE_CELLS`` and ``cell_applicable``.
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

    norm: str = "rms"                 # 'rms' | 'ln'
    act: str = "swiglu"               # 'swiglu' | 'gelu' | 'geglu'
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False

    rope_style: str = "full"          # 'full' | 'partial' | 'mrope' | 'none'
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0        # 'partial': fraction of head_dim rotated
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl: (t, h, w) half-dim sections

    sliding_window: int = 0           # >0: local attention (mixtral, rglru)

    # --- MoE (mixtral) ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden
    first_dense_layers: int = 0       # deepseek: first k layers dense FFN
    routed_scale: float = 1.0
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0              # precomputed frame embeddings length

    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ('rec', 'rec', 'attn')
    d_rnn: int = 0
    conv_width: int = 4

    # --- xlstm ---
    slstm_every: int = 0              # every Nth block is sLSTM (0 = none)
    mlstm_proj_factor: float = 2.0
    slstm_heads: int = 4

    # the dims before ``pad_for_tp`` (0 = never padded)
    orig_n_heads: int = 0
    orig_n_kv_heads: int = 0
    orig_vocab_size: int = 0

    @property
    def q_dim(self) -> int:
        if self.family == "mla_moe":
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "xlstm"

    @property
    def sub_quadratic(self) -> bool:
        """True where a 500k-token decode keeps a bounded state: the
        recurrent families and any sliding window."""
        return self.family in ("rglru", "xlstm") or self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        return True   # every family has a decoder

    def n_params(self) -> int:
        """Total parameter count, from the param spec tree."""
        return sum(n for _, n in _leaf_sizes(self))

    def n_active_params(self) -> int:
        """Parameters touched per token: an ``experts`` leaf counts
        ``top_k / n_experts`` of its size (rounded down), as JAX's."""
        if self.n_experts == 0:
            return self.n_params()
        inactive = sum(n - (n * self.top_k) // self.n_experts
                       for path, n in _leaf_sizes(self)
                       if "experts" in path)
        return self.n_params() - inactive


def _leaf_sizes(cfg: ModelConfig):
    """(path keys, element count) of every leaf of ``cfg``'s param specs."""
    from repro_torch.models.registry import get_model

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, path + (k,))
        else:
            n = 1
            for d in tree.shape:
                n *= int(d)
            yield path, n
    return list(walk(get_model(cfg).param_specs(), ()))


@dataclass(frozen=True)
class ShapeCell:
    """One of the dry-run's shapes: a sequence length, a global batch and
    the step that runs it ('train' | 'prefill' | 'decode')."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPE_CELLS = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Whether a shape cell applies to the arch; the reason where not."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode skipped "
                       "(see DESIGN.md §4)")
    return True, ""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_for_tp(cfg: ModelConfig, tp: int) -> ModelConfig:
    """``cfg`` with the dims a ``tp``-way group shards made divisible by
    ``tp`` (``repro.configs.base.pad_for_tp``'s rule): q heads always;
    kv heads only where there are at least ``tp`` of them (fewer
    replicate, cheaper than inflating the KV); neither for xLSTM, which
    shards its value width; the vocab. The original dims are recorded in
    ``orig_*``."""
    upd = {}
    if cfg.orig_n_heads == 0:
        upd["orig_n_heads"] = cfg.n_heads
        upd["orig_n_kv_heads"] = cfg.n_kv_heads
        upd["orig_vocab_size"] = cfg.vocab_size
    if cfg.family != "xlstm":
        if cfg.n_heads % tp:
            upd["n_heads"] = _round_up(cfg.n_heads, tp)
        if cfg.n_kv_heads >= tp and cfg.n_kv_heads % tp:
            upd["n_kv_heads"] = _round_up(cfg.n_kv_heads, tp)
    if cfg.vocab_size % tp:
        upd["vocab_size"] = _round_up(cfg.vocab_size, tp)
    if not upd:
        return cfg
    return replace(cfg, **upd)


def reduced(cfg: ModelConfig, *, full_heads: bool = False) -> ModelConfig:
    """Tiny same-family config for CPU tests (``repro.configs.base.reduced``
    branch for branch, ``attn_chunk`` aside). With ``full_heads`` the
    attention keeps ``cfg``'s heads, their count and widths (``head_dim``;
    MLA's q / k and v widths) and the rope sections that go with them: a
    tiny model whose attention runs at the shapes the full one's does, as
    the card's attention kernels take them (xLSTM's heads, which attend
    nothing, stay reduced)."""
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
    if cfg.n_experts:
        upd["n_experts"] = min(cfg.n_experts, 4)
        upd["top_k"] = min(cfg.top_k, 2)
        upd["moe_d_ff"] = 64
        upd["first_dense_layers"] = min(cfg.first_dense_layers, 1)
        upd["n_shared_experts"] = min(cfg.n_shared_experts, 1)
    if cfg.family == "mla_moe":
        upd["kv_lora_rank"] = 64
        upd["qk_nope_dim"] = 32
        upd["qk_rope_dim"] = 16
        upd["v_head_dim"] = 32
        upd["head_dim"] = 32
    if full_heads:
        for key in ("n_heads", "n_kv_heads", "head_dim", "qk_nope_dim",
                    "qk_rope_dim", "v_head_dim"):
            upd.pop(key, None)
    if cfg.family == "encdec":
        upd["n_encoder_layers"] = 2
        upd["n_layers"] = 2
        upd["encoder_seq"] = 32
    if cfg.sliding_window:
        upd["sliding_window"] = 32
    if cfg.family == "xlstm":
        upd["n_layers"] = 4
        upd["slstm_every"] = 4
        upd["n_heads"] = 2
        upd["n_kv_heads"] = 2
        upd["head_dim"] = 0   # derived in the model
        upd["d_ff"] = 0
    if cfg.mrope_sections and "head_dim" in upd:
        upd["mrope_sections"] = (4, 6, 6)   # sums to half of head_dim 32
    if cfg.rope_fraction < 1.0:
        upd["rope_fraction"] = 0.5
    return replace(cfg, name=cfg.name + "-reduced", **upd)
