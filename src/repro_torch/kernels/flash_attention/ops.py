"""Wrappers of the attention kernels (counterparts of
``repro.kernels.flash_attention.ops.attention``, ``decode_paged`` and
``decode``), and the training path of ``attention``: on the card, a call
whose q, k or v requires grad (under grad mode) runs the LSE form of
``flash_prefill`` forward and the ``flash_prefill_bwd`` kernels backward
(``attention_lse``, ``attention_bwd``), through ``FlashAttention``.

``attention_cost``, ``attention_lse_cost`` and ``attention_bwd_cost`` give
each kernel's work at a call's shapes: the bound of its kernel-table row,
and what a fake call hands ``runtime.traced`` in a dry-run."""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     decode_attention_ref,
                                                     decode_paged_ref)

_ARGS = [rt.P] * 8 + [rt.I] * 6 + [rt.F, rt.P]
_DENSE_ARGS = [rt.P] * 6 + [rt.I] * 8 + [rt.F, rt.P]
_PREFILL_ARGS = [rt.P] * 4 + [rt.I] * 21 + [rt.F, rt.P]
_LSE_ARGS = [rt.P] * 5 + [rt.I] * 21 + [rt.F, rt.P]
_BWD_ARGS = [rt.P] * 10 + [rt.I] * 10 + [rt.F, rt.P]
# the (dk, dv) head widths flash_prefill is instantiated for, its LSE form
# and its backward too
PREFILL_WIDTHS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))


def _grad_contract(name, Sq, Sk, dk, dv, causal, window, card=True):
    """What the LSE form and the backward kernel take: (dk, dv) in
    ``PREFILL_WIDTHS`` (on the ``card``; the plain versions take any);
    causal or windowed with Sq = Sk, or FULL (neither) with any Sq, Sk.
    Raises ``ValueError`` naming ROADMAP.md otherwise."""
    if (card and (dk, dv) not in PREFILL_WIDTHS) \
            or (Sq != Sk and (causal or window)):
        raise ValueError(
            f"{name}: the training kernels take (dk, dv) in "
            f"{PREFILL_WIDTHS}, causal or windowed with Sq = Sk, or neither "
            f"with any Sq, Sk; got (dk, dv) = ({dk}, {dv}), Sq={Sq}, "
            f"Sk={Sk}, causal={causal}, window={window} (ROADMAP.md, Queue "
            "2: what the training kernels take on the card)")


def attention_pairs(Sq, Sk, causal=True, window=0) -> int:
    """(query, key) pairs a call attends: query i sees key j where j <= i
    (causal) and i - j < window (window > 0); with neither, all Sq x Sk."""
    if not causal and not window:
        return Sq * Sk
    S = Sq
    if causal:
        W = min(window or S, S)
        return W * (W + 1) // 2 + (S - W) * W
    # a window without the causal mask: the keys after i count too
    return S * S - max(0, S - window) * max(0, S - window + 1) // 2


def attention_cost(B, Sq, Sk, Hq, Hkv, dk, dv, causal=True, window=0):
    """``flash_prefill``'s work: q and o (Sq rows), k and v (Sk rows) moved
    once in bf16; q k^T (width dk) and p v (width dv) over the attended
    pairs, 2 per multiply-add."""
    nbytes = 2 * B * (Sq * Hq * (dk + dv) + Sk * Hkv * (dk + dv))
    flops = 2 * B * Hq * (dk + dv) * attention_pairs(Sq, Sk, causal, window)
    return rt.Cost(flops, nbytes)


def attention_lse_cost(B, Sq, Sk, Hq, Hkv, dk, dv, causal=True, window=0):
    """The LSE form's work: ``attention_cost`` and each row's f32
    log-sum-exp written."""
    c = attention_cost(B, Sq, Sk, Hq, Hkv, dk, dv, causal, window)
    return rt.Cost(c.flops, c.bytes + 4 * B * Hq * Sq)


def attention_bwd_cost(B, Sq, Sk, Hq, Hkv, dk, dv, causal=True, window=0):
    """``flash_prefill_bwd``'s work: q, k, v, o, dO and lse read once, dq,
    dk, dv written once (bf16; lse f32); the five products s, dp, dv, dq,
    dk over the attended pairs, 2 per multiply-add: 2 B Hq pairs (3 dk +
    2 dv)."""
    nbytes = 2 * B * (Sq * Hq * (2 * dk + 2 * dv) + 2 * Sk * Hkv * (dk + dv)) \
        + 4 * B * Hq * Sq
    pairs = attention_pairs(Sq, Sk, causal, window)
    return rt.Cost(2 * B * Hq * pairs * (3 * dk + 2 * dv), nbytes)


def _check_head_shape(name, dh, G):
    if dh not in (32, 64, 128, 256):
        raise ValueError(f"{name}: kernel takes dh in 32/64/128/256 (any G), "
                         f"got dh={dh}, G={G}")


def _decode_tile(G):
    """The queries of a kv head's group of G that one CTA of the paged
    kernel serves, as ``decode_core.cuh``'s ``decode_tile``: G itself at
    1/2/4/8, else 1."""
    return G if G in (1, 2, 4, 8) else 1


_chunk = None
_workspaces: dict = {}


def split_chunk() -> int:
    """Positions each CTA of the paged kernel takes (a constant of its
    source); builds the kernel library on first use."""
    global _chunk
    if _chunk is None:
        _chunk = rt.bind("decode_paged", "decode_paged_chunk", [])()
    return _chunk


def _split_workspace(q: torch.Tensor, stream: int, n_part: int,
                     n_count: int, kernel: str):
    """The partial slots (f32) and per-pair counters (int32) of the split
    decode ``kernel`` ("decode_paged" or "flash_decode") for ``q``'s device
    and ``stream``: kept between calls (the counters must start at zero, and
    the kernel leaves them so), each grown when a call needs more; the
    counters are zeroed when they grow. No other kernel shares them."""
    key = (kernel, q.device.index, stream)
    part, count = _workspaces.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    if count is None or count.numel() < n_count:
        count = torch.zeros(n_count, dtype=torch.int32, device=q.device)
    _workspaces[key] = part, count
    return part, count


def decode_paged(q, k_pool, v_pool, tables, len1):
    """Paged-native GQA decode: q (B,Hq,dh) against the block pools
    (rows, block, Hkv, dh). tables (B, maxb) int32, padded with the pool's
    scratch row (every entry must be a valid row); len1 (B,) int32 = valid
    positions per lane including this step's token (positions past
    maxb * block are not attended). Returns (B,Hq,dh).

    CPU tensors take the plain version, in any float dtype; CUDA tensors
    launch the kernel, which takes bf16 q and pools. It splits each lane's
    positions in chunks of ``split_chunk()`` over CTAs and merges them in
    chunk order, in one launch; ``len1`` is never read on the host. Any G
    = Hq / Hkv: a CTA serves ``_decode_tile(G)`` of a head's queries. Its
    scratch lives in a workspace kept per device and stream
    (``_split_workspace``)."""
    B, Hq, dh = q.shape
    rows, block, Hkv, dh_p = k_pool.shape
    if dh_p != dh or Hq % Hkv or v_pool.shape != k_pool.shape:
        raise ValueError(f"decode_paged: q {tuple(q.shape)} does not match "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if not rt.on_card(q, k_pool, v_pool, tables, len1):
        return decode_paged_ref(q, k_pool, v_pool, tables, len1)
    rt.no_backward("decode_paged", q, k_pool, v_pool)
    G = Hq // Hkv
    if not q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16:
        raise TypeError(f"decode_paged: dtypes q={q.dtype} k={k_pool.dtype} "
                        f"v={v_pool.dtype}; the kernel takes bf16 for all "
                        "three")
    if tables.dtype != torch.int32 or len1.dtype != torch.int32:
        raise TypeError("decode_paged: tables and len1 must be int32")
    _check_head_shape("decode_paged", dh, G)
    rt.check_contiguous("decode_paged", q=q, k_pool=k_pool, v_pool=v_pool,
                        tables=tables, len1=len1)
    fn = rt.bind("decode_paged", "decode_paged_bf16", _ARGS)
    maxb = tables.shape[1]
    chunks = -(-maxb * block // split_chunk())
    gt = _decode_tile(G)
    ctas = B * Hkv * (G // gt)                    # CTAs of a chunk
    slot = -(-gt * (dh + 2) // 4) * 4
    stream = rt.stream_ptr(q)
    part, count = _split_workspace(q, stream, ctas * chunks * slot, ctas,
                                   "decode_paged")
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), len1.data_ptr(), out.data_ptr(),
            part.data_ptr(), count.data_ptr(), B, Hkv, G, dh, block, maxb,
            1.0 / math.sqrt(dh), stream)
    rt.check_launch("decode_paged", rc)
    rt.count_launch("decode_paged")
    return out


# the dense kernel's (decode.cu) positions a round of its 4 warps' slices
# of 16 (a chunk of whole rounds keeps the warps even), query rows a CTA
DECODE_STAGE = 64
DECODE_ROWS = 16
# the dense kernel's plan aims at one CTA for every DECODE_SMS_PER_CTA SMs
# of the card; a pair takes at most DECODE_MAX_CHUNKS chunks (decode.cu's
# DD_MAX_CHUNKS)
DECODE_SMS_PER_CTA = 2
DECODE_MAX_CHUNKS = 256


class DecodePlan(NamedTuple):
    """How ``decode`` splits a call over CTAs: each ``pair`` (lane, kv head,
    query tile of up to 16 of the head's G queries) takes ``chunks`` CTAs,
    chunk c the positions [c chunk, min(length, (c + 1) chunk)), none
    empty. Where chunks > 1, each CTA writes a partial of ``slot`` floats
    and each pair has a counter. With ``l1`` the K / V copies allocate in
    L1 (``cp.async.ca``): where the grid gives every SM a CTA, streaming at
    the card's byte rate, row 6 ran 5 % faster so and the smaller rows 6′,
    bound by latency, 3-8 % slower (PERF.md)."""
    chunk: int
    chunks: int
    pairs: int
    slot: int
    l1: bool

    @property
    def ctas(self) -> int:
        return self.pairs * self.chunks

    @property
    def part_floats(self) -> int:
        return self.ctas * self.slot if self.chunks > 1 else 0

    @property
    def counters(self) -> int:
        return self.pairs if self.chunks > 1 else 0


def decode_plan(B, Hkv, G, dh, length, sms, chunk=None) -> DecodePlan:
    """The dense kernel's grid for a call attending ``length`` positions (at
    most the cache's S) on a card of ``sms`` SMs. Unless ``chunk`` is given,
    each pair takes the chunk count nearest ``sms / (DECODE_SMS_PER_CTA *
    pairs)`` (at least 1, at most one ``DECODE_STAGE`` round a chunk and
    ``DECODE_MAX_CHUNKS`` chunks), its positions split evenly in whole
    rounds; so one chunk a pair where the pairs alone give every other SM a
    CTA. On an H100 the rows of 8-16 pairs ran fastest at 64 CTAs of
    256-512 positions: past that, each CTA's fixed costs (its first
    loads' latency, its partial, the merge) outweigh what more CTAs stream
    (PERF.md). A chunk that gives a pair more than ``DECODE_MAX_CHUNKS``
    chunks raises. Host ints only: nothing on the device is read."""
    if length < 1:
        raise ValueError(f"decode_plan: length {length} < 1")
    pairs = B * Hkv * -(-G // DECODE_ROWS)
    if chunk is None:
        want = (sms + pairs * DECODE_SMS_PER_CTA // 2) \
            // (pairs * DECODE_SMS_PER_CTA)
        want = max(1, min(want, -(-length // DECODE_STAGE),
                           DECODE_MAX_CHUNKS))
        chunk = -(-(-(-length // want)) // DECODE_STAGE) * DECODE_STAGE
    chunk = min(chunk, length)
    chunks = -(-length // chunk) if chunk >= 1 else 0
    if not 1 <= chunks <= DECODE_MAX_CHUNKS:
        raise ValueError(f"decode_plan: chunk {chunk} gives {chunks} chunks "
                         f"of {length} positions (1..{DECODE_MAX_CHUNKS})")
    slot = -(-min(G, DECODE_ROWS) * (dh + 2) // 4) * 4
    return DecodePlan(chunk, chunks, pairs, slot, pairs * chunks >= sms)


def decode(q, k_cache, v_cache, length: int, *, chunk=None):
    """Dense-cache GQA decode: q (B,Hq,dh) against caches (B,S,Hkv,dh),
    attending positions ``< length`` (a host int shared by the batch, at
    least 1; past S, all S); the rest of the cache is never read. Returns
    (B,Hq,dh).

    CPU tensors take the plain version, in any float dtype; CUDA tensors
    launch the kernel, which takes bf16 q and caches and any G = Hq / Hkv.
    A CTA serves the whole group of a (lane, kv head) on tensor cores (16
    queries a CTA, sibling CTAs past 16) over a chunk of the positions;
    ``decode_plan`` picks the chunk from the shapes and the card's SMs
    (``chunk`` overrides it), and the chunks' partials merge in chunk order
    within the launch, in a workspace kept per device and stream
    (``_split_workspace``)."""
    B, Hq, dh = q.shape
    _, S, Hkv, dh_c = k_cache.shape
    if (dh_c != dh or Hq % Hkv or k_cache.shape[0] != B
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"decode: q {tuple(q.shape)} does not match caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    length = int(length)
    if length < 1:
        raise ValueError(f"decode: length {length} leaves no position to "
                         "attend")
    if not rt.on_card(q, k_cache, v_cache):
        return decode_attention_ref(q, k_cache, v_cache, length)
    rt.no_backward("decode", q, k_cache, v_cache)
    G = Hq // Hkv
    if not q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16:
        raise TypeError(f"decode: dtypes q={q.dtype} k={k_cache.dtype} "
                        f"v={v_cache.dtype}; the kernel takes bf16 for all "
                        "three")
    _check_head_shape("decode", dh, G)
    rt.check_contiguous("decode", q=q, k_cache=k_cache, v_cache=v_cache)
    fn = rt.bind("flash_decode", "flash_decode_bf16", _DENSE_ARGS)
    L = min(length, S)
    plan = decode_plan(B, Hkv, G, dh, L, rt.device_sms(q.device.index),
                       chunk)
    stream = rt.stream_ptr(q)
    part, count = _split_workspace(q, stream, plan.part_floats,
                                   plan.counters, "flash_decode")
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), part.data_ptr(), count.data_ptr(), B, S, Hkv, G,
            dh, L, plan.chunk, int(plan.l1), 1.0 / math.sqrt(dh), stream)
    rt.check_launch("flash_decode", rc)
    rt.count_launch("flash_decode")
    return out


def _row_strides(name, **tensors):
    """(batch, position, head) strides in elements of BSHD tensors whose
    head_dim is contiguous. The kernel reads and writes them through TMA
    tensor maps, which take a 16-byte aligned base and strides that are
    multiples of 16 bytes."""
    out = []
    for k, t in tensors.items():
        if t.stride(3) != 1 or (not rt.fake(t) and t.data_ptr() % 16) or \
                any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name}: {k} needs a contiguous head_dim and "
                             "16-byte aligned rows")
        out.extend(t.stride()[:3])
    return out


def attention(q, k, v, *, causal=True, window=0):
    """GQA attention over a whole prompt: q (B,Sq,Hq,dk), k (B,Sk,Hkv,dk),
    v (B,Sk,Hkv,dv) -> (B,Sq,Hq,dv), scores scaled by 1/sqrt(dk). Query i
    attends key j where ``j <= i`` (causal) and ``i - j < window`` (window >
    0); with neither, every key. Sk may differ from Sq only then
    (cross-attention); any other call with Sk != Sq raises ``ValueError``,
    on the CPU as on the card. Any Sq, Sk >= 1; the BSHD tensors are read
    by their strides, so a slice of a larger buffer is taken as it is.

    CPU tensors take the plain version, in any float dtype and widths; CUDA
    tensors launch the ``flash_prefill`` kernel, which takes bf16 and the
    (dk, dv) of ``PREFILL_WIDTHS``: dk = dv in 32/64/128/256, or MLA's
    (192, 128)."""
    B, Sq, Hq, dk = q.shape
    Sk = k.shape[1]
    if k.shape[0] != B or k.shape[3] != dk or v.shape[:3] != k.shape[:3] \
            or Hq % k.shape[2]:
        raise ValueError(f"attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"attention: window {window} < 0")
    if Sk != Sq and (causal or window):
        raise ValueError(f"attention: {Sk} keys for {Sq} queries is taken "
                         "only without a causal mask or a window "
                         f"(causal={causal}, window={window})")
    if not rt.on_card(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window)
    Hkv, dv = k.shape[2], v.shape[3]
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"attention: dtypes q={q.dtype} k={k.dtype} "
                        f"v={v.dtype}; the kernel takes bf16 for all three")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _grad_contract("attention", Sq, Sk, dk, dv, causal, window)
        return FlashAttention.apply(q, k, v, bool(causal), int(window))
    if (dk, dv) not in PREFILL_WIDTHS:
        raise ValueError(f"attention: kernel takes (dk, dv) in "
                         f"{PREFILL_WIDTHS}, got ({dk}, {dv})")
    strides = _row_strides("attention", q=q, k=k, v=v)
    if rt.fake(q, k, v):
        return rt.traced("flash_prefill", q.new_empty((B, Sq, Hq, dv)),
                         attention_cost(B, Sq, Sk, Hq, Hkv, dk, dv, causal,
                                        window))
    fn = rt.bind("flash_prefill", "flash_prefill_bf16", _PREFILL_ARGS)
    out = torch.empty((B, Sq, Hq, dv), dtype=q.dtype, device=q.device)
    strides += out.stride()[:3]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, Hq, Hkv, dk, dv, int(causal), int(window), *strides,
            1.0 / math.sqrt(dk), rt.stream_ptr(q))
    rt.check_launch("flash_prefill", rc)
    rt.count_launch("flash_prefill")
    return out


def _lse_shapes(name, q, k, v):
    """(B, Sq, Sk, Hq, Hkv, dk, dv) of q (B,Sq,Hq,dk), k (B,Sk,Hkv,dk), v
    (B,Sk,Hkv,dv), or ValueError."""
    B, Sq, Hq, dk = q.shape
    _, Sk, Hkv, dv = v.shape
    if k.shape != (B, Sk, Hkv, dk) or v.shape[0] != B or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    return B, Sq, Sk, Hq, Hkv, dk, dv


def attention_lse(q, k, v, *, causal=True, window=0):
    """The training forward: (o (B,Sq,Hq,dv), lse (B,Hq,Sq) f32), lse each
    row's log-sum-exp of its scores scaled by 1/sqrt(dk), for q
    (B,Sq,Hq,dk), k (B,Sk,Hkv,dk), v (B,Sk,Hkv,dv) within
    ``_grad_contract``. CPU tensors take the plain version; CUDA tensors
    launch the LSE form of ``flash_prefill`` (bf16), counted as
    ``flash_prefill[lse]``. Gives no gradient itself: ``FlashAttention``
    calls it."""
    B, Sq, Sk, Hq, Hkv, dk, dv = _lse_shapes("attention_lse", q, k, v)
    card = rt.on_card(q, k, v)
    _grad_contract("attention_lse", Sq, Sk, dk, dv, causal, window, card)
    if not card:
        return attention_lse_ref(q, k, v, causal=causal, window=window)
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"attention_lse: the kernel takes bf16, got "
                        f"{q.dtype} / {k.dtype} / {v.dtype}")
    strides = _row_strides("attention_lse", q=q, k=k, v=v)
    if rt.fake(q, k, v):
        return rt.traced("flash_prefill[lse]", (
            q.new_empty((B, Sq, Hq, dv)),
            q.new_empty((B, Hq, Sq), dtype=torch.float32)),
            attention_lse_cost(B, Sq, Sk, Hq, Hkv, dk, dv, causal, window))
    fn = rt.bind("flash_prefill", "flash_prefill_lse_bf16", _LSE_ARGS)
    o = torch.empty((B, Sq, Hq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    strides += o.stride()[:3]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Sq, Sk, Hq, Hkv, dk, dv, int(causal),
            int(window), *strides, 1.0 / math.sqrt(dk), rt.stream_ptr(q))
    rt.check_launch("flash_prefill", rc)
    rt.count_launch("flash_prefill[lse]")
    return o, lse


def attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    """dq, dk, dv (shaped and typed as q, k, v) of ``attention_lse``'s o for
    the upstream gradient ``do``, from its ``lse``. CPU tensors take the
    plain version (``attention_bwd_ref``, f32, cast); CUDA tensors launch
    the ``flash_prefill_bwd`` kernels, which take contiguous bf16 within
    ``_grad_contract`` (one launch count): the row statistics, then dK /
    dV / dQ by a warp-specialised wgmma kernel that forms p once
    (``bwd_kernel`` at d 32 / 64 / 128; ``wide_kernel`` at d 256 and
    (192, 128), the q heads of a kv head split over CTAs where the grid
    would not fill the card: ``flash_prefill_bwd_split``), dq's rounding
    and, where the heads were split, the sum of their dK / dV."""
    B, Sq, Sk, Hq, Hkv, dk, dv = _lse_shapes("attention_bwd", q, k, v)
    if o.shape != (B, Sq, Hq, dv) or do.shape != o.shape \
            or lse.shape != (B, Hq, Sq):
        raise ValueError(f"attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)} / v {tuple(v.shape)}")
    card = rt.on_card(q, k, v, o, lse, do)
    _grad_contract("attention_bwd", Sq, Sk, dk, dv, causal, window, card)
    if not card:
        return tuple(g.to(t.dtype) for g, t in zip(
            attention_bwd_ref(q, k, v, do, causal=causal, window=window),
            (q, k, v)))
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v, o, do)) \
            or lse.dtype != torch.float32:
        raise TypeError("attention_bwd: the kernel takes bf16 q, k, v, o, "
                        "do and f32 lse")
    rt.check_contiguous("attention_bwd", q=q, k=k, v=v, o=o, lse=lse, do=do)
    if rt.fake(q, k, v, o, lse, do):
        return rt.traced("flash_prefill_bwd", tuple(
            torch.empty_like(t) for t in (q, k, v)), attention_bwd_cost(
            B, Sq, Sk, Hq, Hkv, dk, dv, causal, window))
    fn = rt.bind("flash_prefill_bwd", "flash_prefill_bwd_bf16", _BWD_ARGS)
    split = rt.bind("flash_prefill_bwd", "flash_prefill_bwd_split",
                    [rt.I] * 7)(B, Sk, Hq, Hkv, dk, dv,
                                rt.device_sms(q.device.index))
    scratch_floats = rt.bind("flash_prefill_bwd",
                             "flash_prefill_bwd_scratch_floats", [rt.I] * 8)
    scratch_floats.restype = ctypes.c_longlong
    dq, dk_, dv_ = (torch.empty_like(t) for t in (q, k, v))
    # each row's lse * log2(e) and di, dq's f32 sums and the turn counters,
    # padded per (batch, head); the head groups' f32 dK / dV where split
    scratch = torch.empty(scratch_floats(B, Sq, Sk, Hq, Hkv, dk, dv, split),
                          dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dk_.data_ptr(), dv_.data_ptr(), B, Sq, Sk, Hq, Hkv, dk, dv,
            int(causal), int(window), split, 1.0 / math.sqrt(dk),
            rt.stream_ptr(q))
    rt.check_launch("flash_prefill_bwd", rc)
    rt.count_launch("flash_prefill_bwd")
    return dq, dk_, dv_


class FlashAttention(torch.autograd.Function):
    """``attention`` with a gradient: forward ``attention_lse`` (o and each
    row's lse saved with contiguous q, k, v), backward ``attention_bwd``.
    ``attention`` routes here only for a CUDA call under grad mode whose q,
    k or v requires grad; on CPU tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                   window=ctx.window)
        return dq, dk, dv, None, None
