"""Shared layers of the model families (counterpart of
``repro.models.layers``): RMSNorm and LayerNorm, full / partial / m-RoPE,
attention (the quadratic oracle and the ``flash_prefill`` kernel's entry),
single-token attention against a dense cache, the SwiGLU / GeGLU / GELU
FFN with its optional biases, and the routed MoE FFN (top-k with capacity
drops and an optional shared expert)."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    """Statistics in f32, normalised values cast back to x's type before
    the affine, as the JAX function does."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt) * scale + bias


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_specs(cfg: ModelConfig, d=None):
    from repro_torch.models.common import spec
    d = d or cfg.d_model
    out = {"scale": spec((d,), ("embed",), init="ones")}
    if cfg.norm == "ln":
        out["bias"] = spec((d,), ("embed",), init="zeros")
    return out


def _rope_angles(positions, rot_dim, theta):
    """positions (..., S) -> cos/sin of shape (..., S, rot_dim//2). The
    inverse frequencies use the JAX package's numpy arithmetic (float64,
    then f32 on the multiply)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, rot_dim, 2) / rot_dim))
    inv = torch.as_tensor(inv_freq.astype(np.float32), device=positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x, cos, sin):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_dim(cfg: ModelConfig, dh: int) -> int:
    """The rotated elements of a head: all of it, or ``int(dh *
    rope_fraction)`` for partial RoPE, rounded down to even."""
    rot = int(dh * cfg.rope_fraction) if cfg.rope_style == "partial" else dh
    return rot - rot % 2


def apply_rope(cfg: ModelConfig, x, positions):
    """x (B, S, H, dh), positions (B, S) int, or (3, B, S) for m-RoPE (2-D
    positions serve all three sections: text-only input). Only the first
    ``rope_dim`` elements of a head rotate; m-RoPE takes each section's
    frequencies from its own position stream."""
    if cfg.rope_style == "none":
        return x
    dt = x.dtype
    rot = rope_dim(cfg, x.shape[-1])
    if cfg.rope_style == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta)  # (3,B,S,r/2)
        secs = cfg.mrope_sections
        if sum(secs) != rot // 2:
            raise ValueError(f"mrope_sections {secs} must sum to {rot // 2}")
        bounds = np.cumsum((0,) + tuple(secs))
        cos = torch.cat([cos[i, ..., bounds[i]:bounds[i + 1]]
                         for i in range(3)], dim=-1)
        sin = torch.cat([sin[i, ..., bounds[i]:bounds[i + 1]]
                         for i in range(3)], dim=-1)
    else:
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta)
    cos, sin = cos[..., None, :], sin[..., None, :]          # (B,S,1,rot/2)
    xr = _rotate_half(x[..., :rot].float(), cos, sin).to(dt)
    if rot == x.shape[-1]:
        return xr
    return torch.cat([xr, x[..., rot:]], dim=-1)


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Oracle quadratic attention. q (B,Sq,Hq,dh), k (B,Sk,Hkv,dh), v
    (B,Sk,Hkv,dv) -> (B,Sq,Hq,dv); scores and softmax in f32 (scale
    1/sqrt(dh)), probabilities cast to v's dtype for the value product (as
    the JAX oracle does)."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, dv)


def attention(q, k, v, *, causal=True, window=0):
    """Prefill / forward attention, q (B,Sq,Hq,dk), k (B,Sk,Hkv,dk), v
    (B,Sk,Hkv,dv) -> (B,Sq,Hq,dv), scale 1/sqrt(dk); Sk != Sq only for a
    call that is neither causal nor windowed (cross-attention): the
    ``flash_prefill`` kernel on the card (dk = dv, or MLA's 192 / 128), its
    plain version (the quadratic oracle) on the CPU."""
    from repro_torch.kernels.flash_attention import ops
    return ops.attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, valid_mask):
    """Single-token decode. q (B,1,Hq,dh); caches (B,S,Hkv,dh); valid_mask
    (B,S) bool. Scores and softmax in f32; probabilities cast to the cache's
    dtype for the value product, summed in f32 (as the JAX function does)."""
    B, _, Hq, dh = q.shape
    _, S, Hkv, dv = v_cache.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) \
        / math.sqrt(dh)
    s = s.masked_fill(~valid_mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, dv).to(q.dtype)


def _gated(cfg: ModelConfig) -> bool:
    return cfg.act in ("swiglu", "geglu")


def ffn_specs(cfg: ModelConfig, d_ff=None):
    from repro_torch.models.common import spec
    D, F = cfg.d_model, d_ff or cfg.d_ff
    if _gated(cfg):
        p = {"wi_gate": spec((D, F), ("embed", "ffn")),
             "wi_up": spec((D, F), ("embed", "ffn"))}
    else:
        p = {"wi": spec((D, F), ("embed", "ffn"))}
    p["wo"] = spec((F, D), ("ffn", "embed"))
    if cfg.mlp_bias:
        for k in (("bi_gate", "bi_up") if _gated(cfg) else ("bi",)):
            p[k] = spec((F,), ("ffn",), init="zeros")
        p["bo"] = spec((D,), ("embed",), init="zeros")
    return p


def act(cfg: ModelConfig, x):
    """SiLU for SwiGLU; GELU's tanh form (JAX's ``approximate=True``) for
    GeGLU and the plain GELU MLP."""
    if cfg.act == "swiglu":
        return torch.nn.functional.silu(x)
    return torch.nn.functional.gelu(x, approximate="tanh")


def ffn_hidden(cfg: ModelConfig, p, x):
    """The FFN's hidden activation before the down projection: act(gate) *
    up, or act(x @ wi) for the non-gated MLP, with the input biases."""
    bias = cfg.mlp_bias
    if _gated(cfg):
        g = x @ p["wi_gate"]
        u = x @ p["wi_up"]
        if bias:
            g, u = g + p["bi_gate"], u + p["bi_up"]
        return act(cfg, g) * u
    h = x @ p["wi"]
    return act(cfg, h + p["bi"] if bias else h)


def ffn_apply(cfg: ModelConfig, p, x):
    y = ffn_hidden(cfg, p, x) @ p["wo"]
    return y + p["bo"] if cfg.mlp_bias else y


# ----------------------------------------------------------------------
# MoE (sort-based dispatch, as the JAX package's ``moe_apply``)
# ----------------------------------------------------------------------

def moe_specs(cfg: ModelConfig):
    """An f32 router ``(D, E)``, the experts' SwiGLU weights stacked on a
    leading expert axis (fan-in the D or F axis), and, with
    ``n_shared_experts``, one shared FFN of ``moe_d_ff * n_shared`` hidden
    units."""
    from repro_torch.models.common import spec
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": spec((D, E), ("embed", "experts_r"), dtype=torch.float32),
        "experts": {
            "wi_gate": spec((E, D, F), ("experts", "embed", "expert_ffn"),
                            fan_in_axes=(1,)),
            "wi_up": spec((E, D, F), ("experts", "embed", "expert_ffn"),
                          fan_in_axes=(1,)),
            "wo": spec((E, F, D), ("experts", "expert_ffn", "embed"),
                       fan_in_axes=(1,)),
        },
    }
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {"wi_gate": spec((D, Fs), ("embed", "ffn")),
                       "wi_up": spec((D, Fs), ("embed", "ffn")),
                       "wo": spec((Fs, D), ("ffn", "embed"))}
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert holds for ``n_tokens`` tokens: JAX's ``max(1,
    ceil(T * K / E * capacity_factor))`` (the same float expression), at
    most T: an expert takes a token at most once, so slots past T stay
    empty and are never read back (the output is the same)."""
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(math.ceil(n_tokens * K / E * cfg.capacity_factor)))
    return min(C, n_tokens)


def moe_route(cfg: ModelConfig, router, xt):
    """xt (T, D) -> (router logits (T, E) f32, combine weights (T, K) f32,
    experts (T, K)): softmax over the f32 logits, top-k, renormalised over
    the top-k for Mixtral (``family == "moe"``), times ``routed_scale``."""
    logits = xt.float() @ router
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, cfg.top_k, dim=-1)
    if cfg.family == "moe":
        topw = topw / topw.sum(-1, keepdim=True)
    return logits, topw * cfg.routed_scale, topi


def moe_dispatch(cfg: ModelConfig, topi):
    """The (token, choice) assignments of ``topi`` (T, K), flattened token
    by token and sorted stably by expert: (order, each one's expert, its
    rank within the expert). An assignment whose rank reaches
    ``moe_capacity(cfg, T)`` is dropped."""
    eid = topi.reshape(-1)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    # per-expert counts by a scatter (bincount would read its maximum back
    # to the host on the card)
    counts = torch.zeros(cfg.n_experts, dtype=eid_s.dtype,
                         device=eid.device).scatter_add_(
        0, eid_s, torch.ones_like(eid_s))
    starts = torch.cumsum(counts, 0) - counts
    return order, eid_s, torch.arange(len(eid), device=eid.device) \
        - starts[eid_s]


def moe_apply(cfg: ModelConfig, p, x):
    """x (B, S, D) -> (B, S, D). The (token, choice) assignments, sorted
    stably by expert, take the expert's slots in that order; past its
    capacity (``moe_capacity`` of all B * S tokens) an assignment is
    dropped (slot C collects them, zeroed). Each expert's SwiGLU runs on
    its (C, D) slots; the outputs, each cast with its combine weight to
    the activations' type and multiplied, are summed per token in f32,
    then cast. A shared expert's FFN is added after the cast, as JAX's
    does."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    _, topw, topi = moe_route(cfg, p["router"], xt)
    C = moe_capacity(cfg, T)
    order, eid_s, pos = moe_dispatch(cfg, topi)
    tid_s, w_s = order // K, topw.reshape(T * K)[order]
    keep = pos < C
    pos_c = torch.where(keep, pos, torch.full_like(pos, C))
    xe = x.new_zeros((E, C + 1, D))
    xe[eid_s, pos_c] = torch.where(keep[:, None], xt[tid_s],
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    xe = xe[:, :C]
    ye = ffn_hidden(cfg, p["experts"], xe) @ p["experts"]["wo"]   # (E,C,D)
    yc = ye[eid_s, torch.clamp(pos_c, max=C - 1)]
    yc = yc * (w_s * keep.to(w_s.dtype))[:, None].to(yc.dtype)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    out.index_add_(0, tid_s, yc.float())
    out = out.to(x.dtype)
    if cfg.n_shared_experts:
        out = out + ffn_apply(cfg, p["shared"], xt)
    return out.reshape(B, S, D)
