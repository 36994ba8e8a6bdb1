"""Wrappers of the fused-decode kernels (counterparts of
``repro.kernels.fused_decode.kernel``'s ``qkv_rope_paged``,
``oproj_ffn_swiglu``, ``qkv_rope`` and ``ffn_swiglu``) and the dense-cache
decoder-layer step composed from them (``ops.decoder_layer_step``). CPU
tensors take the plain versions in ``ref.py``; CUDA tensors launch the
hand-written kernels, which take bf16 activations and weights, or the call
raises."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import decode
from repro_torch.kernels.fused_decode.ref import (ffn_swiglu_ref, layer_step,
                                                  oproj_ffn_swiglu_ref,
                                                  qkv_rope_paged_ref,
                                                  qkv_rope_ref,
                                                  rope_inv_freq)

_QKV_ARGS = [rt.P] * 11 + [rt.I] * 7 + [rt.P]
_EPI_ARGS = [rt.P] * 13 + [rt.I] * 6 + [rt.P]
_QKV_DENSE_ARGS = [rt.P] * 6 + [rt.I] * 8 + [rt.P]
_FFN_ARGS = [rt.P] * 10 + [rt.I] * 5 + [rt.P]
_SMS = 132            # H100 SXM streaming multiprocessors
_TILE_N = 64          # the epilogue's column tile
_MIN_ROWS = 256       # fewest weight rows a K split streams


@functools.lru_cache(maxsize=16)
def _inv_freq(dh: int, theta: float, rope_frac: float, device: str):
    return torch.as_tensor(rope_inv_freq(dh, theta, rope_frac), device=device)


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
        inv = _inv_freq(dh, float(theta), 1.0, "cpu")
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
    inv = _inv_freq(dh, float(theta), 1.0, str(x.device))
    Ht = Hq + 2 * Hkv
    splits = _head_splits(Ht, D)
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


def _head_splits(n_heads: int, k: int) -> int:
    """D splits of the per-head products so that about two CTAs per SM
    run."""
    return max(1, min(8, -(-2 * _SMS // n_heads), k // _MIN_ROWS))


def _ffn_scratch(B: int, D: int, F: int, splits_d: int, device):
    """f32 scratch of the FFN passes: y (B,D), per-256-column sums of y^2,
    h (B,F) and the down-projection's split partials."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, D), **f32), torch.empty((B, -(-D // 256)), **f32),
            torch.empty((B, F), **f32), torch.empty((splits_d, B, D), **f32))


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
    out = torch.empty_like(x)
    y, ss, h, p_d = _ffn_scratch(B, D, F, sd, x.device)
    p_o = torch.empty((so, B, D), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), attn_out.data_ptr(), w_o.data_ptr(),
            norm_scale.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), out.data_ptr(), y.data_ptr(), ss.data_ptr(),
            h.data_ptr(), p_o.data_ptr(), p_d.data_ptr(), B, D, HD, F, so, sd,
            rt.stream_ptr(x))
    rt.check_launch("oproj_ffn_swiglu", rc)
    rt.count_launch("oproj_ffn_swiglu")
    return out


# ------------------------------------------------- dense (shared position)
def qkv_rope(x, norm_scale, w_qkv, pos: int, *, n_q, n_kv, dh, theta=10000.0,
             rope_frac=1.0):
    """RMSNorm + QKV + RoPE at one position for the dense-cache decode step.

    x (B,D); w_qkv (D, (n_q+2*n_kv)*dh) = wq|wk|wv; ``pos`` a host int
    shared by the batch. Returns (n_q+2*n_kv, B, dh) in x.dtype, head-major,
    with RoPE on the q and k heads over their first ``int(dh * rope_frac)``
    (even) elements; v heads are not rotated. On the card this is two
    launches of the hand-written kernel (see its source) with f32 scratch
    from ``torch.empty``."""
    B, D = x.shape
    Ht = n_q + 2 * n_kv
    if w_qkv.shape != (D, Ht * dh):
        raise ValueError(f"qkv_rope: w_qkv {tuple(w_qkv.shape)} is not "
                         f"({D}, {Ht * dh})")
    pos = int(pos)
    if not rt.on_card(x, norm_scale, w_qkv):
        return qkv_rope_ref(x, norm_scale, w_qkv, pos, n_q=n_q, n_kv=n_kv,
                            dh=dh, theta=theta, rope_frac=rope_frac)
    _check_bf16("qkv_rope", x=x, norm_scale=norm_scale, w_qkv=w_qkv)
    if dh not in (32, 64, 128, 256):
        raise ValueError(f"qkv_rope: kernel takes dh in 32/64/128/256, got "
                         f"{dh}")
    rt.check_contiguous("qkv_rope", x=x, norm_scale=norm_scale, w_qkv=w_qkv)
    fn = rt.bind("qkv_rope", "qkv_rope_bf16", _QKV_DENSE_ARGS)
    inv = _inv_freq(dh, float(theta), float(rope_frac), str(x.device))
    splits = _head_splits(Ht, D)
    out = torch.empty((Ht, B, dh), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, B, Ht * dh), dtype=torch.float32,
                          device=x.device)
    rc = fn(x.data_ptr(), norm_scale.data_ptr(), w_qkv.data_ptr(),
            inv.data_ptr(), out.data_ptr(), partial.data_ptr(), B, D, n_q,
            n_kv, dh, pos, inv.shape[0], splits, rt.stream_ptr(x))
    rt.check_launch("qkv_rope", rc)
    rt.count_launch("qkv_rope")
    return out


def ffn_swiglu(x, norm_scale, w_gate, w_up, w_down, *, residual=True):
    """x + SwiGLU(RMSNorm(x)) @ w_down; with ``residual=False`` only
    SwiGLU(RMSNorm(x)) @ w_down, the tensor-parallel partial form.

    x (B,D); w_gate/w_up (D,F); w_down (F,D). Returns (B,D) in x.dtype. On
    the card this is four launches of the hand-written kernel (see its
    source); scratch comes from ``torch.empty``."""
    B, D = x.shape
    F = w_gate.shape[1]
    if (w_gate.shape != (D, F) or w_up.shape != (D, F)
            or w_down.shape != (F, D)):
        raise ValueError("ffn_swiglu: weight shapes do not match")
    if not rt.on_card(x, norm_scale, w_gate, w_up, w_down):
        return ffn_swiglu_ref(x, norm_scale, w_gate, w_up, w_down,
                              residual=residual)
    _check_bf16("ffn_swiglu", x=x, norm_scale=norm_scale, w_gate=w_gate,
                w_up=w_up, w_down=w_down)
    if D % 8 or F % 8:
        raise ValueError(f"ffn_swiglu: kernel needs D and F multiples of 8, "
                         f"got D={D}, F={F}")
    rt.check_contiguous("ffn_swiglu", x=x, norm_scale=norm_scale,
                        w_gate=w_gate, w_up=w_up, w_down=w_down)
    fn = rt.bind("ffn_swiglu", "ffn_swiglu_bf16", _FFN_ARGS)
    sd = _splits(D, F)
    out = torch.empty_like(x)
    y, ss, h, p_d = _ffn_scratch(B, D, F, sd, x.device)
    rc = fn(x.data_ptr(), norm_scale.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), out.data_ptr(), y.data_ptr(),
            ss.data_ptr(), h.data_ptr(), p_d.data_ptr(), B, D, F, sd,
            int(bool(residual)), rt.stream_ptr(x))
    rt.check_launch("ffn_swiglu", rc)
    rt.count_launch("ffn_swiglu")
    return out


def decoder_layer_step(x, p, k_cache, v_cache, pos: int, *, n_q, n_kv, dh,
                       theta=10000.0):
    """One decoder layer's decode step against a dense cache, on the
    kernels: ``qkv_rope`` -> K/V written at ``pos`` -> ``decode`` over
    ``pos + 1`` positions -> ``x + o @ w_o`` (a plain ``torch.matmul``, as
    JAX leaves it to XLA) -> ``ffn_swiglu``.

    x (B,D); ``p`` from ``layer_step_params``; caches (B,S,n_kv,dh), written
    in place (JAX donates them) and returned; ``pos`` a host int shared by
    the batch. Returns (y (B,D), k_cache, v_cache)."""
    return layer_step(qkv_rope, decode, ffn_swiglu, x, p, k_cache, v_cache,
                      pos, n_q=n_q, n_kv=n_kv, dh=dh, theta=theta)


def layer_step_params(params, i: int):
    """``decoder_layer_step``'s ``p`` for layer ``i`` of a dense model tree:
    ``attn_norm``, ``w_qkv`` (D, (Hq+2*Hkv)*dh) = wq|wk|wv, ``w_o``
    (Hq*dh, D), ``mlp_norm``, ``w_gate``, ``w_up``, ``w_down``. Every entry
    is a view of the tree except ``w_qkv``, a new tensor (100 MB per layer
    at 7B): build the layers' dicts once per expert and reuse them for
    every step."""
    from repro_torch.models.transformer import layer_params
    lp = layer_params(params, i)
    a = lp["attn"]
    D = a["wq"].shape[0]
    return {"attn_norm": a["norm"]["scale"],
            "w_qkv": torch.cat([a[w].reshape(D, -1)
                                for w in ("wq", "wk", "wv")], dim=1),
            "w_o": a["wo"].reshape(-1, D),
            "mlp_norm": lp["mlp_norm"]["scale"],
            "w_gate": lp["mlp"]["wi_gate"],
            "w_up": lp["mlp"]["wi_up"],
            "w_down": lp["mlp"]["wo"]}
