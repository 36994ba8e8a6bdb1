"""Shared layers of the dense and rglru families (counterpart of
``repro.models.layers``): RMSNorm, full RoPE, attention (the quadratic
oracle and the ``flash_prefill`` kernel's entry), single-token attention
against a dense cache, and the SwiGLU / GeGLU FFN."""
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


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm != "rms":
        raise NotImplementedError(
            f"norm={cfg.norm!r} is not ported yet (ROADMAP.md Queue 1)")
    return rms_norm(x, p["scale"])


def norm_specs(cfg: ModelConfig, d=None):
    from repro_torch.models.common import spec
    return {"scale": spec((d or cfg.d_model,), ("embed",), init="ones")}


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


def apply_rope(cfg: ModelConfig, x, positions):
    """x (B, S, H, dh), positions (B, S) int. Full-style RoPE only."""
    if cfg.rope_style == "none":
        return x
    if cfg.rope_style != "full":
        raise NotImplementedError(
            f"rope_style={cfg.rope_style!r} is not ported yet (ROADMAP.md)")
    dt = x.dtype
    rot = x.shape[-1] - x.shape[-1] % 2
    cos, sin = _rope_angles(positions, rot, cfg.rope_theta)
    cos, sin = cos[..., None, :], sin[..., None, :]          # (B,S,1,rot/2)
    xr = _rotate_half(x[..., :rot].float(), cos, sin).to(dt)
    if rot == x.shape[-1]:
        return xr
    return torch.cat([xr, x[..., rot:]], dim=-1)


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Oracle quadratic attention. q (B,Sq,Hq,dh), k/v (B,Sk,Hkv,dh); scores
    and softmax in f32, probabilities cast to v's dtype for the value
    product (as the JAX oracle does)."""
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
    """Prefill / forward attention, q (B,S,Hq,dh), k/v (B,S,Hkv,dh): the
    ``flash_prefill`` kernel on the card, its plain version (the quadratic
    oracle) on the CPU."""
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


def ffn_specs(cfg: ModelConfig, d_ff=None):
    from repro_torch.models.common import spec
    D, F = cfg.d_model, d_ff or cfg.d_ff
    return {"wi_gate": spec((D, F), ("embed", "ffn")),
            "wi_up": spec((D, F), ("embed", "ffn")),
            "wo": spec((F, D), ("ffn", "embed"))}


def ffn_apply(cfg: ModelConfig, p, x):
    if cfg.act not in ("swiglu", "geglu") or cfg.mlp_bias:
        raise NotImplementedError(
            f"act={cfg.act!r}, mlp_bias={cfg.mlp_bias} is not ported yet")
    g = x @ p["wi_gate"]
    u = x @ p["wi_up"]
    act = torch.nn.functional.silu(g) if cfg.act == "swiglu" else \
        torch.nn.functional.gelu(g, approximate="tanh")
    return (act * u) @ p["wo"]
