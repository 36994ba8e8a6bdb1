"""Wrapper of the RG-LRU recurrence kernel (counterpart of
``repro.kernels.lru_scan.ops.lru_scan``) and its backward: on the card, a
call whose a or b requires grad (under grad mode) runs the forward kernel
and, backward, ``lru_scan_bwd``, through ``LruScan``. ``lru_scan_cost`` and
``lru_scan_bwd_cost`` give each kernel's work (its kernel-table row's
bound, and a dry-run's fake call's)."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref, lru_scan_ref

_ARGS = [rt.P] * 3 + [rt.I] * 3 + [rt.P]
_BWD_ARGS = [rt.P] * 5 + [rt.I] * 3 + [rt.P]


def _check_f32(name, **tensors):
    for k, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} is {t.dtype}; the kernel takes "
                            "f32")
    rt.check_contiguous(name, **tensors)


def lru_scan_cost(B, S, D):
    """``lru_scan``'s work: a and b read once and h written once, f32; a
    multiply and an add an element."""
    return rt.Cost(2 * B * S * D, 3 * 4 * B * S * D)


def lru_scan_bwd_cost(B, S, D):
    """``lru_scan_bwd``'s work: a, h and dh read once, da and db written
    once, f32; g_t = dh_t + a_{t+1} g_{t+1} and da_t = g_t h_{t-1}: three
    flops an element."""
    return rt.Cost(3 * B * S * D, 5 * 4 * B * S * D)


def _scan(a, b):
    """The forward kernel's launch on CUDA f32 a, b."""
    _check_f32("lru_scan", a=a, b=b)
    B, S, D = a.shape
    if rt.fake(a, b):
        return rt.traced("lru_scan", torch.empty_like(a),
                         lru_scan_cost(B, S, D))
    fn = rt.bind("lru_scan", "lru_scan_f32", _ARGS)
    h = torch.empty_like(a)
    rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D,
            rt.stream_ptr(a))
    rt.check_launch("lru_scan", rc)
    rt.count_launch("lru_scan")
    return h


def lru_scan(a, b):
    """a, b (B, S, D) -> h (B, S, D), h_t = a_t h_{t-1} + b_t, h_{-1} = 0.

    CPU tensors take the plain version, in any float dtype (autograd runs
    through it); CUDA tensors launch the kernel, which takes contiguous f32
    (the type the RG-LRU coefficients come in), and under grad mode with an
    input that requires grad go through ``LruScan``, whose backward is the
    ``lru_scan_bwd`` kernel."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"lru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be the same (B, S, D)")
    if not rt.on_card(a, b):
        return lru_scan_ref(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return LruScan.apply(a, b)
    return _scan(a, b)


def lru_scan_bwd(a, h, dh):
    """(da, db) of ``lru_scan(a, b)`` = h for the upstream gradient dh, all
    (B, S, D): g_t = dh_t + a_{t+1} g_{t+1}, db = g, da_t = g_t h_{t-1}.
    CPU tensors take the plain version; CUDA tensors launch the
    ``lru_scan_bwd`` kernel (contiguous f32), counted as ``lru_scan_bwd``."""
    if a.dim() != 3 or h.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"lru_scan_bwd: a {tuple(a.shape)}, h "
                         f"{tuple(h.shape)} and dh {tuple(dh.shape)} must be "
                         "the same (B, S, D)")
    if not rt.on_card(a, h, dh):
        return lru_scan_bwd_ref(a, h, dh)
    _check_f32("lru_scan_bwd", a=a, h=h, dh=dh)
    B, S, D = a.shape
    if rt.fake(a, h, dh):
        return rt.traced("lru_scan_bwd", (torch.empty_like(a),
                                          torch.empty_like(a)),
                         lru_scan_bwd_cost(B, S, D))
    fn = rt.bind("lru_scan", "lru_scan_bwd_f32", _BWD_ARGS)
    da, db = torch.empty_like(a), torch.empty_like(a)
    rc = fn(a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
            db.data_ptr(), B, S, D, rt.stream_ptr(a))
    rt.check_launch("lru_scan", rc)
    rt.count_launch("lru_scan_bwd")
    return da, db


class LruScan(torch.autograd.Function):
    """``lru_scan`` with a gradient: forward the kernel (a and h saved),
    backward ``lru_scan_bwd``. On CPU tensors both are the plain
    versions."""

    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b) if rt.on_card(a, b) else lru_scan_ref(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return lru_scan_bwd(a, h, dh.contiguous())
