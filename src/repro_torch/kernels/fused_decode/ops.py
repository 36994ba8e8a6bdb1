"""Wrappers of the paged fused-decode kernels (counterparts of
``repro.kernels.fused_decode.kernel.qkv_rope_paged`` and
``oproj_ffn_swiglu``). CPU tensors take the plain versions in ``ref.py``;
CUDA tensors launch the hand-written kernels, which take bf16 activations
and weights, or the call raises."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.fused_decode.ref import (oproj_ffn_swiglu_ref,
                                                  qkv_rope_paged_ref,
                                                  rope_inv_freq)

_QKV_ARGS = [rt.P] * 11 + [rt.I] * 7 + [rt.P]
_EPI_ARGS = [rt.P] * 13 + [rt.I] * 6 + [rt.P]
_SMS = 132            # H100 SXM streaming multiprocessors
_TILE_N = 64          # the epilogue's column tile
_MIN_ROWS = 256       # fewest weight rows a K split streams


@functools.lru_cache(maxsize=16)
def _inv_freq(dh: int, theta: float, device: str):
    return torch.as_tensor(rope_inv_freq(dh, theta), device=device)


def _check_bf16(name, **tensors):
    for k, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {k} is {t.dtype}; the kernel takes "
                            "bf16")


def qkv_rope_paged(x, norm_scale, wq, wk, wv, pos, *, theta=10000.0):
    """RMSNorm + QKV + per-lane RoPE for the paged decode step.

    x (B,D); wq (D,Hq,dh), wk/wv (D,Hkv,dh) — the native attention layout;
    pos (B,) int32 per-lane positions. Returns q (B,Hq,dh), k, v (B,Hkv,dh)
    in x.dtype, with RoPE on q and k. On the card this is two launches of
    the hand-written kernel (see its source) with f32 scratch from
    ``torch.empty``."""
    B, D = x.shape
    _, Hq, dh = wq.shape
    Hkv = wk.shape[1]
    if wq.shape[0] != D or wk.shape != (D, Hkv, dh) or wv.shape != wk.shape:
        raise ValueError("qkv_rope_paged: weight shapes do not match x")
    if not rt.on_card(x, norm_scale, wq, wk, wv, pos):
        inv = _inv_freq(dh, float(theta), "cpu")
        return qkv_rope_paged_ref(x, norm_scale, wq, wk, wv, pos, inv)
    _check_bf16("qkv_rope_paged", x=x, norm_scale=norm_scale, wq=wq, wk=wk,
                wv=wv)
    if pos.dtype != torch.int32:
        raise TypeError("qkv_rope_paged: pos must be int32")
    if dh not in (32, 64, 128, 256):
        raise ValueError(f"qkv_rope_paged: kernel takes dh in 32/64/128/256, "
                         f"got {dh}")
    rt.check_contiguous("qkv_rope_paged", x=x, norm_scale=norm_scale, wq=wq,
                        wk=wk, wv=wv, pos=pos)
    fn = rt.bind("qkv_rope_paged", "qkv_rope_paged_bf16", _QKV_ARGS)
    inv = _inv_freq(dh, float(theta), str(x.device))
    Ht = Hq + 2 * Hkv
    splits = max(1, min(8, -(-2 * _SMS // Ht), D // _MIN_ROWS))
    q = torch.empty((B, Hq, dh), dtype=x.dtype, device=x.device)
    k = torch.empty((B, Hkv, dh), dtype=x.dtype, device=x.device)
    v = torch.empty_like(k)
    partial = torch.empty((splits, B, Ht * dh), dtype=torch.float32,
                          device=x.device)
    rc = fn(x.data_ptr(), norm_scale.data_ptr(), wq.data_ptr(), wk.data_ptr(),
            wv.data_ptr(), pos.data_ptr(), inv.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), partial.data_ptr(), B, D, Hq, Hkv, dh,
            inv.shape[0], splits, rt.stream_ptr(x))
    rt.check_launch("qkv_rope_paged", rc)
    rt.count_launch("qkv_rope_paged")
    return q, k, v


def _splits(n_cols: int, k: int) -> int:
    """K splits of a skinny product so that about two CTAs per SM run."""
    tiles = -(-n_cols // _TILE_N)
    return max(1, min(8, -(-2 * _SMS // tiles), k // _MIN_ROWS))


def oproj_ffn_swiglu(x, attn_out, w_o, norm_scale, w_gate, w_up, w_down):
    """The decoder-layer epilogue:

        y = x + attn_out @ w_o ;  return y + SwiGLU(RMSNorm(y)) @ w_down

    x (B,D); attn_out (B, Hq*dh); w_o (Hq*dh, D) (the native (Hq,dh,D) ``wo``
    reshaped); w_gate/w_up (D,F); w_down (F,D). Returns (B,D) in x.dtype.
    On the card this is five launches of the hand-written kernel (see its
    source); scratch comes from ``torch.empty``."""
    B, D = x.shape
    HD = attn_out.shape[1]
    F = w_gate.shape[1]
    if (w_o.shape != (HD, D) or w_gate.shape != (D, F)
            or w_up.shape != (D, F) or w_down.shape != (F, D)):
        raise ValueError("oproj_ffn_swiglu: weight shapes do not match")
    if not rt.on_card(x, attn_out, w_o, norm_scale, w_gate, w_up, w_down):
        return oproj_ffn_swiglu_ref(x, attn_out, w_o, norm_scale, w_gate,
                                    w_up, w_down)
    _check_bf16("oproj_ffn_swiglu", x=x, attn_out=attn_out, w_o=w_o,
                norm_scale=norm_scale, w_gate=w_gate, w_up=w_up,
                w_down=w_down)
    if D % 8 or F % 8:
        raise ValueError(f"oproj_ffn_swiglu: kernel needs D and F multiples "
                         f"of 8, got D={D}, F={F}")
    rt.check_contiguous("oproj_ffn_swiglu", x=x, attn_out=attn_out, w_o=w_o,
                        norm_scale=norm_scale, w_gate=w_gate, w_up=w_up,
                        w_down=w_down)
    fn = rt.bind("oproj_ffn_swiglu", "oproj_ffn_swiglu_bf16", _EPI_ARGS)
    so, sd = _splits(D, HD), _splits(D, F)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    y = torch.empty((B, D), **f32)
    ss = torch.empty((B, -(-D // 256)), **f32)      # per-chunk sum of y^2
    h = torch.empty((B, F), **f32)
    p_o = torch.empty((so, B, D), **f32)
    p_d = torch.empty((sd, B, D), **f32)
    rc = fn(x.data_ptr(), attn_out.data_ptr(), w_o.data_ptr(),
            norm_scale.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), out.data_ptr(), y.data_ptr(), ss.data_ptr(),
            h.data_ptr(), p_o.data_ptr(), p_d.data_ptr(), B, D, HD, F, so, sd,
            rt.stream_ptr(x))
    rt.check_launch("oproj_ffn_swiglu", rc)
    rt.count_launch("oproj_ffn_swiglu")
    return out
