"""Roofline terms of a dry-run (counterpart of ``repro.launch.roofline``),
modelled with the data-sheet constants of the H100 80GB HBM3 SXM at 700 W,
not measured.

Three terms per (arch, shape, mesh), in seconds:
    compute    = flops / (chips x 989e12)             [bf16 dense peak / GPU]
    memory     = bytes / (chips x 3.35e12)            [HBM3 / GPU]
    collective = collective_bytes / (chips x 450e9)   [NVLink 4, one way]

``flops`` and ``bytes`` are what the dry-run's trace counts on one rank's
fake tensors (``launch.dryrun``), times the chips: the registry's flop
formula of each local aten op plus each kernel's cost function, and each
local op's inputs and outputs plus each kernel's bytes (the unfused upper
bound, as XLA's 'bytes accessed' is). Collective bytes are the result
bytes of the ``_c10d_functional`` collectives the trace records, by kind
(``collective_bytes``); there is no HLO text to parse. The field names
(``hlo_flops``, ``hlo_bytes``) are JAX's, so the two packages' records
read alike.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Iterable, Optional, Tuple

# H100 80GB HBM3 SXM at 700 W, data sheet: dense bf16 tensor-core peak
PEAK_FLOPS = 989e12
# H100 80GB HBM3 SXM at 700 W, data sheet: HBM3 bandwidth
HBM_BW = 3.35e12
# H100 80GB HBM3 SXM at 700 W, data sheet: NVLink 4, 900 GB/s both ways,
# 450e9 one way. A 16-wide model axis spans two 8-GPU nodes, whose link
# between them is slower than NVLink, so this term is optimistic there.
LINK_BW = 450e9

# the collectives a trace records (``torch.ops._c10d_functional``) by the
# kind JAX's HLO names them; ``wait_tensor`` completes one and moves
# nothing more, as JAX skips an op's ``-done``
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Per-kind result bytes summed over a trace's ``(op name, result
    bytes)`` collective records (``COLLECTIVE_KINDS``; any other name,
    ``wait_tensor`` among them, is skipped)."""
    out: Dict[str, int] = {}
    for name, nbytes in records:
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None:
            out[kind] = out.get(kind, 0) + int(nbytes)
    return out


@dataclass
class RooflineTerms:
    arch: str
    cell: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_breakdown: Dict[str, int]
    model_flops: float
    per_device_peak_bytes: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful model FLOPs achieved vs chip peak, assuming the step runs
        at the max of the three terms (MFU-style score for compute;
        bandwidth-utilization analogue when memory/collective bound)."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.step_s if self.step_s else 0.0

    def as_dict(self):
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, bottleneck=self.bottleneck,
                 step_s=self.step_s, useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def min_traffic_bytes(cfg, cell) -> float:
    """Analytic lower bound on global device-memory traffic per step: every
    live byte moves once (the traced bytes are an upper bound that counts
    each op's inputs and outputs)."""
    N = cfg.n_params()
    Na = cfg.n_active_params()
    B, S = cell.global_batch, cell.seq_len
    D = cfg.d_model
    L = cfg.n_layers
    act_token_bytes = 2 * D * L  # one residual read+write per layer, bf16
    if cell.kind == "train":
        tokens = B * S
        # params read (fwd+bwd) + grad write + adam moments r/w (f32) +
        # master update; activations: residuals once + remat recompute
        return (N * 2 * 3) + (N * 4 * 4) + tokens * act_token_bytes * 3
    if cell.kind == "prefill":
        tokens = B * S
        kv = _cache_bytes(cfg, B, S)
        return Na * 2 + tokens * act_token_bytes * 2 + kv
    # decode
    kv = _cache_bytes(cfg, B, min(S, cfg.sliding_window or S))
    return Na * 2 + kv + B * act_token_bytes


def _cache_bytes(cfg, B, S) -> float:
    if cfg.family == "mla_moe":
        return 2.0 * cfg.n_layers * B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    if cfg.family == "rglru":
        W = min(S, cfg.sliding_window or S)
        n_attn = max(1, cfg.n_layers // len(cfg.block_pattern))
        rec = (cfg.n_layers - n_attn) * B * cfg.d_rnn * 4
        return 2.0 * n_attn * B * W * cfg.n_kv_heads * cfg.head_dim * 2 + rec
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import _dims
        Dm, Di, H, dh, _ = _dims(cfg)
        return cfg.n_layers * B * H * dh * dh * 4.0
    return 2.0 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * 2


def model_flops_cell(cfg, cell) -> float:
    """Analytic useful FLOPs for the cell (6ND train / 2ND decode + attn)."""
    N = cfg.n_active_params()
    B, S = cell.global_batch, cell.seq_len
    dh = cfg.head_dim or 0
    kv = cfg.n_kv_heads
    if cell.kind == "train":
        tokens = B * S
        base = 6.0 * N * tokens
        # attention score/value flops (forward 2x2, backward x2 => x3 of fwd)
        attn = 0.0
        if cfg.family in ("dense", "moe", "encdec"):
            ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
            attn = 3 * 2 * 2 * cfg.n_layers * B * S * (ctx / 2) * cfg.n_heads * dh
        return base + attn
    if cell.kind == "prefill":
        tokens = B * S
        base = 2.0 * N * tokens
        attn = 0.0
        if cfg.family in ("dense", "moe", "encdec", "mla_moe"):
            ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
            hd = dh if cfg.family != "mla_moe" else (cfg.qk_nope_dim +
                                                     cfg.qk_rope_dim)
            attn = 2 * 2 * cfg.n_layers * B * S * (ctx / 2) * cfg.n_heads * hd
        return base + attn
    # decode: one token, context S
    base = 2.0 * N * B
    attn = 0.0
    if cfg.family in ("dense", "moe", "encdec"):
        ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
        attn = 2 * 2 * cfg.n_layers * B * ctx * cfg.n_kv_heads * \
            (cfg.n_heads // max(cfg.n_kv_heads, 1)) * dh
    elif cfg.family == "mla_moe":
        attn = 2 * 2 * cfg.n_layers * B * S * cfg.n_heads * \
            (cfg.kv_lora_rank + cfg.qk_rope_dim) / 2
    return base + attn
