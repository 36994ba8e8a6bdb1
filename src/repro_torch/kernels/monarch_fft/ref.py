"""Plain PyTorch versions of the Monarch-FFT kernels (paper Fig. 3).

The simplified Monarch decomposition from the paper:
    Gemm0 -> Mul(twiddle) -> Transpose -> Gemm1
x: (B, N1, N2), w0: (N1, N1), tw: (N1, N2), w1: (N2, N2) -> out (B, N2, N1).

``monarch_conv_ref`` composes two passes around a pointwise filter: the
FlashFFTConv structure (FFT -> filter -> iFFT) the paper benchmarks.

The port's copy of ``repro.kernels.monarch_fft.ref``, with its rounding
points: products accumulate in f32 (operands upcast, which equals
``preferred_element_type=f32`` for bf16 inputs), the twiddled intermediate
is cast to ``w1.dtype`` before the second product, the output to
``x.dtype``; the conv's filter multiply runs in the pass output's type.
"""
from __future__ import annotations

import torch


def _mm(w, x):
    """einsum("ij,bjk->bik") accumulated in f32."""
    return torch.matmul(w.float(), x.float())


def monarch_ref(x, w0, tw, w1):
    a = _mm(w0, x) * tw.float()
    at = a.transpose(1, 2)                          # (B, N2, N1)
    return _mm(w1, at.to(w1.dtype)).to(x.dtype)


def monarch_unfused_ref(x, w0, tw, w1):
    """Same math, op-by-op with materialization between each step (the
    paper's unfused baseline)."""
    a = _mm(w0, x).to(x.dtype)                      # materialize
    a = (a * tw).to(x.dtype)                        # materialize
    at = a.transpose(1, 2).contiguous()             # materialize
    return _mm(w1, at).to(x.dtype)


def monarch_conv_ref(x, w0, tw, w1, filt, w0i, twi, w1i):
    """FFT-conv structure: monarch -> pointwise filter -> inverse monarch."""
    f = monarch_ref(x, w0, tw, w1)                  # (B, N2, N1)
    f = f * filt                                    # pointwise filter (N2, N1)
    return monarch_ref(f, w0i, twi, w1i)            # (B, N1, N2) back
