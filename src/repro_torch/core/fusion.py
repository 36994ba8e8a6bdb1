"""Fusion planner (counterpart of ``repro.core.fusion``): the
streaming-dataflow analogue at the graph level.

The paper's compiler fuses 20+ ops per kernel automatically (Fig 11). On
the H100 the port's answer is its hand-written kernels: a fused group of
``FUSED_GROUPS`` is one of them, whose intermediate activations stay on
the chip (registers and shared memory) and never reach device memory. On
the paged decode path the groups are ``qkv_rope_paged`` (``qkv_rope``:
the norm, the three projections and RoPE), ``decode_paged``
(``flash_attention``: the cache append, scores, softmax and values) and
``oproj_ffn_swiglu``, one kernel for both ``oproj_residual`` and
``ffn_fused`` (the output projection, its residual, the MLP's norm and
SwiGLU FFN, and the second residual): the plan counts them as the two
groups JAX's names, so its counts and bytes are JAX's. This module models
the op list of a decoder layer for any ModelConfig and reports, per fusion
level:
  * kernel-launch counts (paper Fig 11),
  * device-memory traffic and operational intensity (paper Table I).

Byte accounting per op: ``weight_bytes`` (parameters, read once per step in
either regime), ``stream_bytes`` (KV-cache-like streams, read in either
regime), ``act_in``/``act_out`` (activations: these round-trip to device
memory when UNFUSED, and stay on the chip inside a fused group). The
arithmetic, and the order of every sum, are JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Op:
    name: str
    flops: float
    weight_bytes: float = 0.0
    act_in: float = 0.0
    act_out: float = 0.0
    stream_bytes: float = 0.0

    @property
    def total_bytes(self):
        return self.weight_bytes + self.act_in + self.act_out + self.stream_bytes


def decoder_layer_ops(cfg: ModelConfig, batch: int, ctx: int,
                      seq: int = 1, dtype_bytes: int = 2) -> List[Op]:
    """Op list for one layer processing ``seq`` new tokens per sequence
    against ``ctx`` context (decode: seq=1; prefill/train: seq=S, ctx=S)."""
    D, F = cfg.d_model, cfg.d_ff or cfg.moe_d_ff
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = batch
    T = B * seq                       # tokens processed this step
    act = T * D * dtype_bytes
    qb = T * Hq * dh * dtype_bytes
    kvb = T * Hkv * dh * dtype_bytes
    cache = B * ctx * Hkv * dh * dtype_bytes
    score = T * Hq * ctx * dtype_bytes

    ops = [
        Op("rmsnorm_attn", 4 * T * D, D * dtype_bytes, act, act),
        Op("q_proj", 2 * T * D * Hq * dh, D * Hq * dh * dtype_bytes, act, qb),
        Op("k_proj", 2 * T * D * Hkv * dh, D * Hkv * dh * dtype_bytes, act, kvb),
        Op("v_proj", 2 * T * D * Hkv * dh, D * Hkv * dh * dtype_bytes, act, kvb),
        Op("rope", 6 * T * (Hq + Hkv) * dh, 0, qb + kvb, qb + kvb),
        Op("cache_append", 0, 0, kvb, kvb),
        Op("attn_scores", 2 * T * Hq * dh * ctx, 0, qb, score,
           stream_bytes=cache),
        Op("softmax", 5 * T * Hq * ctx, 0, score, score),
        Op("attn_values", 2 * T * Hq * dh * ctx, 0, score, qb,
           stream_bytes=cache),
        Op("o_proj", 2 * T * Hq * dh * D, Hq * dh * D * dtype_bytes, qb, act),
        Op("residual_1", T * D, 0, 2 * act, act),
        Op("rmsnorm_mlp", 4 * T * D, D * dtype_bytes, act, act),
    ]
    hidden = T * F * dtype_bytes
    wDF = D * F * dtype_bytes
    if cfg.act in ("swiglu", "geglu"):
        ops += [
            Op("gate_proj", 2 * T * D * F, wDF, act, hidden),
            Op("up_proj", 2 * T * D * F, wDF, act, hidden),
            Op("act_mul", 3 * T * F, 0, 2 * hidden, hidden),
            Op("down_proj", 2 * T * F * D, wDF, hidden, act),
        ]
    else:
        ops += [
            Op("up_proj", 2 * T * D * F, wDF, act, hidden),
            Op("act", 2 * T * F, 0, hidden, hidden),
            Op("down_proj", 2 * T * F * D, wDF, hidden, act),
        ]
    ops.append(Op("residual_2", T * D, 0, 2 * act, act))
    if cfg.n_experts:
        ops.append(Op("router_gemm", 2 * T * D * cfg.n_experts,
                      D * cfg.n_experts * dtype_bytes, act,
                      T * cfg.n_experts * dtype_bytes))
        ops.append(Op("topk_dispatch", 8 * T * cfg.n_experts, 0,
                      T * cfg.n_experts * dtype_bytes, act))
    return ops


# the fused plan: which ops collapse into each fused kernel
FUSED_GROUPS = [
    ("qkv_rope", ["rmsnorm_attn", "q_proj", "k_proj", "v_proj", "rope"]),
    ("flash_attention", ["cache_append", "attn_scores", "softmax",
                         "attn_values"]),
    ("oproj_residual", ["o_proj", "residual_1"]),
    ("ffn_fused", ["rmsnorm_mlp", "gate_proj", "up_proj", "act_mul", "act",
                   "down_proj", "residual_2"]),
    ("moe_fused", ["router_gemm", "topk_dispatch"]),
]


@dataclass
class FusionReport:
    unfused_kernels: int
    fused_kernels: int
    unfused_hbm_bytes: float
    fused_hbm_bytes: float
    flops: float

    @property
    def launch_ratio(self) -> float:
        return self.unfused_kernels / max(1, self.fused_kernels)

    @property
    def traffic_ratio(self) -> float:
        return self.unfused_hbm_bytes / self.fused_hbm_bytes

    @property
    def intensity_unfused(self) -> float:
        return self.flops / self.unfused_hbm_bytes

    @property
    def intensity_fused(self) -> float:
        return self.flops / self.fused_hbm_bytes


def plan(cfg: ModelConfig, batch: int, ctx: int, seq: int = 1,
         dtype_bytes: int = 2) -> FusionReport:
    ops = decoder_layer_ops(cfg, batch, ctx, seq, dtype_bytes)
    by_name: Dict[str, Op] = {o.name: o for o in ops}
    flops = sum(o.flops for o in ops)
    unfused_bytes = sum(o.total_bytes for o in ops)

    fused_kernels = 0
    fused_bytes = 0.0
    covered = set()
    for kname, members in FUSED_GROUPS:
        group = [by_name[m] for m in members if m in by_name and
                 m not in covered]
        if not group:
            continue
        covered.update(o.name for o in group)
        fused_kernels += 1
        # fused: weights + external streams read once; activations stay on
        # the chip except the group input and the group output
        fused_bytes += (sum(o.weight_bytes + o.stream_bytes for o in group)
                        + group[0].act_in + group[-1].act_out)
    for o in ops:
        if o.name not in covered:
            fused_kernels += 1
            fused_bytes += o.total_bytes

    return FusionReport(len(ops), fused_kernels, unfused_bytes, fused_bytes,
                        flops)


def model_fusion_report(cfg: ModelConfig, batch: int, ctx: int,
                        seq: int = 1, dtype_bytes: int = 2) -> FusionReport:
    """Whole-model per-step report (layers x per-layer + embed/head)."""
    r = plan(cfg, batch, ctx, seq, dtype_bytes)
    L = cfg.n_layers
    T = batch * seq
    head_flops = 2 * T * cfg.d_model * cfg.vocab_size
    head_bytes = (cfg.d_model * cfg.vocab_size + T * cfg.vocab_size) \
        * dtype_bytes
    return FusionReport(
        unfused_kernels=r.unfused_kernels * L + 2,
        fused_kernels=r.fused_kernels * L + 2,
        unfused_hbm_bytes=r.unfused_hbm_bytes * L + head_bytes,
        fused_hbm_bytes=r.fused_hbm_bytes * L + head_bytes,
        flops=r.flops * L + head_flops,
    )


def backend_prediction(cfg: ModelConfig, batch: int, ctx: int,
                       backend: str, seq: int = 1,
                       dtype_bytes: int = 2) -> Dict[str, float]:
    """Model-predicted per-decode-step device-memory bytes and operational
    intensity for a serving backend (``serving/backends.py``): 'xla' runs
    the unfused op graph (every inter-op activation round-trips to device
    memory), 'fused' the hand-written kernels' plan (activations stay on
    the chip inside each ``FUSED_GROUPS`` entry)."""
    r = model_fusion_report(cfg, batch, ctx, seq, dtype_bytes)
    fused = backend == "fused"
    return {
        "backend": backend,
        "predicted_hbm_bytes": r.fused_hbm_bytes if fused
        else r.unfused_hbm_bytes,
        "predicted_intensity": r.intensity_fused if fused
        else r.intensity_unfused,
        "predicted_kernels": r.fused_kernels if fused else r.unfused_kernels,
        "flops": r.flops,
    }
