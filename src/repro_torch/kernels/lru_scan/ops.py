"""Wrapper of the RG-LRU recurrence kernel (counterpart of
``repro.kernels.lru_scan.ops.lru_scan``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.lru_scan.ref import lru_scan_ref

_ARGS = [rt.P] * 3 + [rt.I] * 3 + [rt.P]


def lru_scan(a, b):
    """a, b (B, S, D) -> h (B, S, D), h_t = a_t h_{t-1} + b_t, h_{-1} = 0.

    CPU tensors take the plain version, in any float dtype; CUDA tensors
    launch the kernel, which takes contiguous f32 (the type the RG-LRU
    coefficients come in)."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"lru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be the same (B, S, D)")
    if not rt.on_card(a, b):
        return lru_scan_ref(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"lru_scan: dtypes a={a.dtype} b={b.dtype}; the "
                        "kernel takes f32")
    rt.check_contiguous("lru_scan", a=a, b=b)
    B, S, D = a.shape
    fn = rt.bind("lru_scan", "lru_scan_f32", _ARGS)
    h = torch.empty_like(a)
    rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D,
            rt.stream_ptr(a))
    rt.check_launch("lru_scan", rc)
    rt.count_launch("lru_scan")
    return h
