"""Wrappers of the Monarch-FFT kernels (counterparts of
``repro.kernels.monarch_fft.ops``'s ``monarch``, ``monarch_conv`` and
``operational_intensity``). CPU tensors take the plain versions in
``ref.py``, in any float dtype; CUDA tensors launch the hand-written
kernels, which take bf16 (the type Table I counts), or the call raises.
The kernels' tiles come from ``monarch_plan``: there is no ``block_n1``."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.monarch_fft.ref import monarch_conv_ref, monarch_ref

_MONARCH_ARGS = [rt.P] * 5 + [rt.I] * 6 + [rt.P]
_CONV_ARGS = [rt.P] * 10 + [rt.I] * 9 + [rt.P]
# The largest N2 whose N1-block intermediates fit a block's 227 KB of
# shared memory at the smallest block of 16 rows (monarch_plan)
MONARCH_MAX_N2 = 5888
MONARCH_CONV_MAX_N2 = 2304

# The plan's arithmetic, as monarch_core.cuh does it: a ring stage of 128
# rows x 64 k bf16; the B ring's two slots, the conv's epilogue slot; the
# barriers.
_A_STAGE = 128 * 64 * 2
_SLOTS = 2
_MAX_STAGES = 6          # the kernels take up to 8
_BAR_BYTES = 8 * 2 * (8 + 2 * _SLOTS + 1)
_BACK_TILE = 128         # conv_back_kernel's square output tile


class MonarchPlan(NamedTuple):
    """How a Monarch kernel tiles one shape: ``bm`` rows of N1 a CTA, a
    ring of ``stages`` 16 KB tiles, phase 1 in slabs of ``chunks`` 128-row
    chunk pairs, ``smem`` bytes of dynamic shared memory, ``ctas`` CTAs."""
    bm: int
    stages: int
    chunks: int
    smem: int
    ctas: int


def monarch_smem(bm, stages, N2, conv):
    """Dynamic shared memory of a front launch (``monarch_core.cuh::
    smem_bytes``): alignment slack, the resident A_blk (and the conv's
    F_blk^T), the ring, the B ring, the conv's epilogue slot, barriers."""
    return (1024 + bm * N2 * 2 * (2 if conv else 1) + stages * _A_STAGE
            + _SLOTS * bm * 64 * 2 + (128 * bm * 2 if conv else 0)
            + _BAR_BYTES)


def monarch_plan(B, N1, N2, smem_limit, conv=False):
    """The tiling of ``monarch`` (``conv`` False) or ``monarch_conv``'s
    front launch at (B, N1, N2), N1 % 64 == 0, N2 % 128 == 0, on a card
    whose blocks may have ``smem_limit`` bytes of dynamic shared memory:
    the largest block (64, 32, 16 rows; the conv 32, 16) whose shared
    memory fits, with at least three stages where any block has them; the
    most stages that fit, up to six; a slab of all the chunk pairs the
    accumulators hold (4 at bm 64, 8 below) where that divides N2 / 128,
    else of one."""
    fits = []
    for bm in ((32, 16) if conv else (64, 32, 16)):
        stages = max((s for s in range(2, _MAX_STAGES + 1)
                      if monarch_smem(bm, s, N2, conv) <= smem_limit),
                     default=0)
        if stages:
            fits.append((bm, stages))
    if not fits:
        raise ValueError(f"monarch_plan: N2 = {N2} leaves no block within "
                         f"{smem_limit} bytes of shared memory")
    if any(s >= 3 for _, s in fits):
        fits = [(bm, s) for bm, s in fits if s >= 3]
    bm, stages = fits[0]
    slab = 4 if bm == 64 else 8
    chunks = slab if (N2 // 128) % slab == 0 else 1
    return MonarchPlan(bm, stages, chunks,
                       monarch_smem(bm, stages, N2, conv), B * N1 // bm)


def monarch_conv_plan(B, N1, N2, sms, smem_limit):
    """How ``monarch_conv`` runs at (B, N1, N2) on a card of ``sms`` SMs
    (``smem_limit`` as in ``monarch_plan``): ``(front, None)``, one front
    launch (phases 1-3 of each N1 block, ``monarch_plan(conv=True)``) and
    the back GEMM; or ``(forward, inverse)``, two passes on the pass
    kernel: F = bf16(bf16(monarch(x)) * filt) at (B, N1, N2), then
    monarch(F) at (B, N2, N1).

    The front holds A_blk and F_blk together, so its blocks are half the
    pass's (32 rows at most) and its products half as wide; it is kept
    where its grid fits one wave, one CTA an SM (PERF.md times both forms),
    and where the passes cannot run: they need N1 % 128 == 0 and N1 <=
    MONARCH_MAX_N2 (the second pass's N2)."""
    front = monarch_plan(B, N1, N2, smem_limit, conv=True)
    if N1 % 128 or N1 > MONARCH_MAX_N2 or front.ctas <= sms:
        return front, None
    return (monarch_plan(B, N1, N2, smem_limit),
            monarch_plan(B, N2, N1, smem_limit))


def monarch_l2_bytes(B, N1, N2, plan, conv=False):
    """Bytes each launch of one call reads from L2, modelled from the plan:
    every bf16 tile a CTA loads, once. ``{"pass": ...}`` for ``monarch`` with
    ``plan``; for the conv, with ``plan`` from ``monarch_conv_plan``,
    ``{"front": ..., "back": ...}`` or ``{"forward": ..., "inverse":
    ...}``."""
    e = 2

    def front_launch(N1, N2, p, conv, filt):
        # x[b], W1 (and W0i) whole; W0[blk] once a slab, tw[blk] (and the
        # filter, twi) once
        streamed = (N1 * N2 + N2 * N2 * (2 if conv else 1)) * e
        slabs = N2 // 128 // p.chunks
        own = (p.bm * N1 * slabs
               + p.bm * N2 * (3 if conv else 2 if filt else 1)) * e
        return p.ctas * (streamed + own)

    if not conv:
        return {"pass": front_launch(N1, N2, plan, False, False)}
    first, second = plan
    if second is not None:
        return {"forward": front_launch(N1, N2, first, False, True),
                "inverse": front_launch(N2, N1, second, False, False)}
    tiles = B * -(-N1 // _BACK_TILE) * (N2 // _BACK_TILE)
    return {"front": front_launch(N1, N2, first, True, False),
            "back": tiles * (min(N1, _BACK_TILE) + _BACK_TILE) * N1 * e}


@functools.lru_cache(maxsize=16)
def card_limits(name, index):
    """(SMs, opt-in shared memory of a block in bytes) of CUDA device
    ``index``, the latter as kernel library ``name`` reads it: what the
    plans fit a launch into."""
    smem_limit = rt.bind(name, "monarch_smem_limit", [])
    with torch.cuda.device(index):
        return rt.device_sms(index), smem_limit()


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
    rt.no_backward("monarch", x, w0, tw, w1)
    _check_card("monarch", N2, MONARCH_MAX_N2,
                dict(x=x, w0=w0, tw=tw, w1=w1))
    _, smem = card_limits("monarch_fused", x.device.index)
    plan = monarch_plan(B, N1, N2, smem)
    fn = rt.bind("monarch_fused", "monarch_bf16", _MONARCH_ARGS)
    z = torch.empty((B, N2, N1), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), w0.data_ptr(), tw.data_ptr(), w1.data_ptr(),
            z.data_ptr(), B, N1, N2, *plan[:3], rt.stream_ptr(x))
    rt.check_launch("monarch_fused", rc)
    rt.count_launch("monarch_fused")
    return z


def monarch_conv(x, w0, tw, w1, filt, w0i, twi, w1i):
    """Monarch, pointwise filter, inverse monarch: x (B, N1, N2) ->
    (B, N1, N2), with w0 (N1, N1), tw (N1, N2), w1 (N2, N2), filt (N2, N1),
    w0i (N2, N2), twi (N2, N1), w1i (N1, N1). On the card one call is one
    ``monarch_conv_fused`` launch count: its C entry runs two CUDA kernels
    as ``monarch_conv_plan`` says (``conv_front_kernel``, the N1-block-local
    products, then ``conv_back_kernel``, the last product across blocks;
    or ``conv_forward_kernel`` and ``conv_inverse_kernel``, the two
    passes)."""
    _check_shapes("monarch_conv", x, w0=(w0, ("N1", "N1")),
                  tw=(tw, ("N1", "N2")), w1=(w1, ("N2", "N2")),
                  filt=(filt, ("N2", "N1")), w0i=(w0i, ("N2", "N2")),
                  twi=(twi, ("N2", "N1")), w1i=(w1i, ("N1", "N1")))
    args = (x, w0, tw, w1, filt, w0i, twi, w1i)
    if not rt.on_card(*args):
        return monarch_conv_ref(*args)
    rt.no_backward("monarch_conv", *args)
    B, N1, N2 = x.shape
    _check_card("monarch_conv", N2, MONARCH_CONV_MAX_N2,
                dict(x=x, w0=w0, tw=tw, w1=w1, filt=filt, w0i=w0i, twi=twi,
                     w1i=w1i))
    first, second = monarch_conv_plan(
        B, N1, N2, *card_limits("monarch_conv_fused", x.device.index))
    fn = rt.bind("monarch_conv_fused", "monarch_conv_bf16", _CONV_ARGS)
    bm = torch.empty((B, N2, N1), dtype=x.dtype, device=x.device)
    z = torch.empty_like(x)
    rc = fn(*(t.data_ptr() for t in args), bm.data_ptr(), z.data_ptr(), B,
            N1, N2, *first[:3], *(second or (0, 0, 0))[:3], rt.stream_ptr(x))
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
