"""Plain PyTorch versions of the paged fused-decode kernels: the same
arithmetic as the Pallas kernels (f32 inside, cast to x's type at the end)."""
from __future__ import annotations

import numpy as np
import torch


def rms_ref(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * scale.float()


def rope_inv_freq(dh: int, theta: float) -> np.ndarray:
    """(rot/2,) f32 inverse frequencies of full RoPE, with the host numpy
    arithmetic of the JAX kernel wrapper (``qkv_rope_paged``), so both
    packages agree."""
    rot = dh - dh % 2
    return (1.0 / (theta ** (np.arange(0, rot, 2) / rot))).astype(np.float32)


def _rope(y, pos, inv_freq):
    """y (B, H, dh) f32 rotated by each lane's position; the first
    2 * len(inv_freq) elements rotate, the rest pass through."""
    half = inv_freq.shape[0]
    ang = pos.float()[:, None] * inv_freq[None, :]            # (B, rot/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    y1, y2, yp = y[..., :half], y[..., half:2 * half], y[..., 2 * half:]
    return torch.cat([y1 * cos - y2 * sin, y2 * cos + y1 * sin, yp], dim=-1)


def qkv_rope_paged_ref(x, norm_scale, wq, wk, wv, pos, inv_freq):
    """x (B,D); wq (D,Hq,dh), wk/wv (D,Hkv,dh); pos (B,) int; inv_freq
    (rot/2,) f32 tensor. Returns q (B,Hq,dh), k, v (B,Hkv,dh) in x.dtype."""
    xn = rms_ref(x, norm_scale)
    q = torch.einsum("bd,dhk->bhk", xn, wq.float())
    k = torch.einsum("bd,dhk->bhk", xn, wk.float())
    v = torch.einsum("bd,dhk->bhk", xn, wv.float())
    q, k = _rope(q, pos, inv_freq), _rope(k, pos, inv_freq)
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def oproj_ffn_swiglu_ref(x, attn_out, w_o, norm_scale, w_gate, w_up, w_down):
    """y = x + attn_out @ w_o; out = y + SwiGLU(RMSNorm(y)) @ w_down, in f32,
    cast to x.dtype."""
    y = x.float() + attn_out.float() @ w_o.float()
    yn = rms_ref(y, norm_scale)
    g = yn @ w_gate.float()
    u = yn @ w_up.float()
    h = g * torch.sigmoid(g) * u
    return (y + h @ w_down.float()).to(x.dtype)
