"""Plain PyTorch versions of the fused-decode kernels: the same arithmetic as
the Pallas kernels (f32 inside, cast to x's type at the end). The paged
forms take per-lane positions; the dense forms (``qkv_rope_ref``,
``ffn_swiglu_ref``, ``decoder_layer_step_ref``) one position shared by the
batch, as ``repro.kernels.fused_decode.ref`` does."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ref import decode_attention_ref


def rms_ref(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * scale.float()


def rope_inv_freq(dh: int, theta: float, rope_frac: float = 1.0) -> np.ndarray:
    """(rot/2,) f32 inverse frequencies over the ``rot`` rotated elements of
    a head (``rot = int(dh * rope_frac)`` rounded down to even), with the
    host numpy arithmetic of the JAX kernel wrapper (``qkv_rope_paged``), so
    both packages agree."""
    rot = int(dh * rope_frac) - int(dh * rope_frac) % 2
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


# ------------------------------------------------- dense (shared position)
def rope_ref(y, pos: int, theta: float, rope_frac: float = 1.0):
    """y (B, H, dh) f32 rotated at the position ``pos`` shared by the batch;
    the first ``rot`` elements rotate (see ``rope_inv_freq``), the rest pass
    through."""
    inv = torch.as_tensor(rope_inv_freq(y.shape[-1], theta, rope_frac),
                          device=y.device)
    return _rope(y, torch.full(y.shape[:1], int(pos), device=y.device), inv)


def qkv_rope_ref(x, norm_scale, w_qkv, pos: int, *, n_q, n_kv, dh,
                 theta=10000.0, rope_frac=1.0):
    """x (B,D); w_qkv (D, (n_q+2*n_kv)*dh) = wq|wk|wv. Returns (H, B, dh) in
    x.dtype, head-major, with RoPE on the q and k heads (v unrotated)."""
    B = x.shape[0]
    y = (rms_ref(x, norm_scale) @ w_qkv.float()).reshape(B, -1, dh)
    qk = rope_ref(y[:, :n_q + n_kv], pos, theta, rope_frac)
    out = torch.cat([qk, y[:, n_q + n_kv:]], dim=1)
    return out.transpose(0, 1).to(x.dtype).contiguous()


def ffn_swiglu_ref(x, norm_scale, w_gate, w_up, w_down, *, residual=True):
    """x + SwiGLU(RMSNorm(x)) @ w_down in f32, cast to x.dtype; with
    ``residual=False`` only SwiGLU(RMSNorm(x)) @ w_down (the tensor-parallel
    partial form, summed across shards before the residual add)."""
    xn = rms_ref(x, norm_scale)
    g = xn @ w_gate.float()
    u = xn @ w_up.float()
    out = (g * torch.sigmoid(g) * u) @ w_down.float()
    if residual:
        out = x.float() + out
    return out.to(x.dtype)


def layer_step(qkv_rope, decode, ffn_swiglu, x, p, k_cache, v_cache,
               pos: int, *, n_q, n_kv, dh, theta):
    """One decoder layer's decode step composed from the three given
    functions: qkv_rope -> cache write at ``pos`` -> decode at ``pos + 1``
    -> x + o @ w_o -> ffn_swiglu. Writes the caches (B,S,n_kv,dh) in place
    and returns (y (B,D), k_cache, v_cache)."""
    B = x.shape[0]
    pos = int(pos)
    qkv = qkv_rope(x, p["attn_norm"], p["w_qkv"], pos, n_q=n_q, n_kv=n_kv,
                   dh=dh, theta=theta)                      # (H,B,dh)
    k_cache[:, pos] = qkv[n_q:n_q + n_kv].transpose(0, 1)
    v_cache[:, pos] = qkv[n_q + n_kv:].transpose(0, 1)
    o = decode(qkv[:n_q].transpose(0, 1).contiguous(), k_cache, v_cache,
               pos + 1)
    y = x + (o.reshape(B, n_q * dh) @ p["w_o"]).to(x.dtype)
    y = ffn_swiglu(y, p["mlp_norm"], p["w_gate"], p["w_up"], p["w_down"])
    return y, k_cache, v_cache


def decoder_layer_step_ref(x, p, k_cache, v_cache, pos: int, *, n_q, n_kv,
                           dh, theta=10000.0):
    """The full decode step of one layer in the plain versions. x (B,D);
    caches (B,S,n_kv,dh), written in place. Returns (y, k_cache, v_cache)."""
    return layer_step(qkv_rope_ref, decode_attention_ref, ffn_swiglu_ref, x,
                      p, k_cache, v_cache, pos, n_q=n_q, n_kv=n_kv, dh=dh,
                      theta=theta)
