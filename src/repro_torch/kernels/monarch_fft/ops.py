"""Wrappers of the Monarch-FFT kernels (counterparts of
``repro.kernels.monarch_fft.ops``'s ``monarch``, ``monarch_conv`` and
``operational_intensity``). CPU tensors take the plain versions in
``ref.py``, in any float dtype; CUDA tensors launch the hand-written
kernels, which take bf16 (the type Table I counts), or the call raises.
The kernels pick their own tiles: there is no ``block_n1``."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.monarch_fft.ref import monarch_conv_ref, monarch_ref

_MONARCH_ARGS = [rt.P] * 5 + [rt.I] * 3 + [rt.P]
_CONV_ARGS = [rt.P] * 10 + [rt.I] * 3 + [rt.P]
# The largest N2 whose N1-block intermediates fit a block's 227 KB of
# shared memory at the smallest block of 16 rows (monarch.cu,
# monarch_conv.cu)
MONARCH_MAX_N2 = 5888
MONARCH_CONV_MAX_N2 = 2304


def _check_shapes(name, x, **factors):
    """x (B, N1, N2) and each factor of the shape ``factors`` names it by
    (a pair of "N1" / "N2")."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (B, N1, N2)")
    n = {"N1": x.shape[1], "N2": x.shape[2]}
    for k, (t, dims) in factors.items():
        want = tuple(n[d] for d in dims)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {k} {tuple(t.shape)} is not {dims} "
                             f"= {want} for x {tuple(x.shape)}")


def _check_card(name, N2, max_n2, tensors):
    for k, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {k} is {t.dtype}; the kernel takes "
                            "bf16")
    N1 = tensors["x"].shape[1]
    if N1 % 64 or N2 % 128 or N2 > max_n2:
        raise ValueError(f"{name}: the kernel tiles N1 % 64 == 0 and "
                         f"N2 % 128 == 0 with N2 <= {max_n2}; got N1 = {N1}, "
                         f"N2 = {N2}")
    rt.check_contiguous(name, **tensors)


def monarch(x, w0, tw, w1):
    """Z[b] = W1 . ((W0 . x[b]) * tw)^T: x (B, N1, N2), w0 (N1, N1),
    tw (N1, N2), w1 (N2, N2) -> (B, N2, N1). N1 % min(128, N1) == 0, as the
    Pallas kernel asserts."""
    _check_shapes("monarch", x, w0=(w0, ("N1", "N1")), tw=(tw, ("N1", "N2")),
                  w1=(w1, ("N2", "N2")))
    B, N1, N2 = x.shape
    if N1 % min(128, N1):
        raise ValueError(f"monarch: N1 = {N1} is not a multiple of "
                         f"min(128, N1)")
    if not rt.on_card(x, w0, tw, w1):
        return monarch_ref(x, w0, tw, w1)
    _check_card("monarch", N2, MONARCH_MAX_N2,
                dict(x=x, w0=w0, tw=tw, w1=w1))
    fn = rt.bind("monarch_fused", "monarch_bf16", _MONARCH_ARGS)
    z = torch.empty((B, N2, N1), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), w0.data_ptr(), tw.data_ptr(), w1.data_ptr(),
            z.data_ptr(), B, N1, N2, rt.stream_ptr(x))
    rt.check_launch("monarch_fused", rc)
    rt.count_launch("monarch_fused")
    return z


def monarch_conv(x, w0, tw, w1, filt, w0i, twi, w1i):
    """Monarch, pointwise filter, inverse monarch: x (B, N1, N2) ->
    (B, N1, N2), with w0 (N1, N1), tw (N1, N2), w1 (N2, N2), filt (N2, N1),
    w0i (N2, N2), twi (N2, N1), w1i (N1, N1). On the card one call is one
    ``monarch_conv_fused`` launch count: its C entry runs two CUDA kernels
    (the N1-block-local products, then the last product across blocks)."""
    _check_shapes("monarch_conv", x, w0=(w0, ("N1", "N1")),
                  tw=(tw, ("N1", "N2")), w1=(w1, ("N2", "N2")),
                  filt=(filt, ("N2", "N1")), w0i=(w0i, ("N2", "N2")),
                  twi=(twi, ("N2", "N1")), w1i=(w1i, ("N1", "N1")))
    args = (x, w0, tw, w1, filt, w0i, twi, w1i)
    if not rt.on_card(*args):
        return monarch_conv_ref(*args)
    B, N1, N2 = x.shape
    _check_card("monarch_conv", N2, MONARCH_CONV_MAX_N2,
                dict(x=x, w0=w0, tw=tw, w1=w1, filt=filt, w0i=w0i, twi=twi,
                     w1i=w1i))
    fn = rt.bind("monarch_conv_fused", "monarch_conv_bf16", _CONV_ARGS)
    bm = torch.empty((B, N2, N1), dtype=x.dtype, device=x.device)
    z = torch.empty_like(x)
    rc = fn(*(t.data_ptr() for t in args), bm.data_ptr(), z.data_ptr(), B,
            N1, N2, rt.stream_ptr(x))
    rt.check_launch("monarch_conv_fused", rc)
    rt.count_launch("monarch_conv_fused")
    return z


def monarch_flops_bytes(B, N1, N2, dtype_bytes=2, fusion="full"):
    """(flops, bytes) of the Fig-3 pipeline at a given fusion level:
    'none' (every op materializes to device memory), 'gemm0_mul_t' (first
    three ops fused), 'full' (everything fused: x, the three factors and
    the output moved once)."""
    flops = 2 * B * N1 * N1 * N2 + B * N1 * N2 + 2 * B * N2 * N2 * N1
    x_b = B * N1 * N2 * dtype_bytes
    w_b = (N1 * N1 + N1 * N2 + N2 * N2) * dtype_bytes
    out_b = B * N2 * N1 * dtype_bytes
    inter = B * N1 * N2 * dtype_bytes       # one intermediate tensor
    if fusion == "none":
        # gemm0: x+w0 in, a out; mul: a+tw in, a out; transpose: a in/out;
        # gemm1: a+w1 in, z out
        bytes_ = (x_b + N1 * N1 * dtype_bytes + inter) + \
                 (inter + N1 * N2 * dtype_bytes + inter) + \
                 (2 * inter) + (inter + N2 * N2 * dtype_bytes + out_b)
    elif fusion == "gemm0_mul_t":
        bytes_ = (x_b + (N1 * N1 + N1 * N2) * dtype_bytes + inter) + \
                 (inter + N2 * N2 * dtype_bytes + out_b)
    else:
        bytes_ = x_b + w_b + out_b
    return flops, bytes_


def monarch_conv_flops_bytes(B, N1, N2, dtype_bytes=2):
    """(flops, bytes) of the whole FFT-conv, fully fused: two Monarch
    passes and the filter multiply; x and the output moved once, the seven
    factor matrices read once."""
    flops = monarch_flops_bytes(B, N1, N2)[0] + B * N1 * N2 + \
        monarch_flops_bytes(B, N2, N1)[0]
    x_b = out_b = B * N1 * N2 * dtype_bytes
    factors = 2 * N1 * N1 + 2 * N2 * N2 + 3 * N1 * N2
    return flops, x_b + factors * dtype_bytes + out_b


def operational_intensity(B, N1, N2, dtype_bytes=2, fusion="full"):
    """FLOPs/byte for the Fig-3 pipeline at a given fusion level (paper
    Table I rows): 'none', 'gemm0_mul_t', 'full'."""
    flops, bytes_ = monarch_flops_bytes(B, N1, N2, dtype_bytes, fusion)
    return flops / bytes_
