"""Wrappers of the attention kernels (counterparts of
``repro.kernels.flash_attention.ops.attention``, ``decode_paged`` and
``decode``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     decode_attention_ref,
                                                     decode_paged_ref)

_ARGS = [rt.P] * 8 + [rt.I] * 6 + [rt.F, rt.P]
_DENSE_ARGS = [rt.P] * 4 + [rt.I] * 6 + [rt.F, rt.P]
_PREFILL_ARGS = [rt.P] * 4 + [rt.I] * 19 + [rt.F, rt.P]


def _check_head_shape(name, dh, G):
    if dh not in (32, 64, 128, 256) or G not in (1, 2, 4, 8):
        raise ValueError(f"{name}: kernel takes dh in 32/64/128/256 and G in "
                         f"1/2/4/8, got dh={dh}, G={G}")


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
                     n_count: int):
    """The paged kernel's partial slots (f32) and per-(lane, head) counters
    (int32) for ``q``'s device and ``stream``: kept between calls (the
    counters must start at zero, and the kernel leaves them so), each grown
    when a call needs more; the counters are zeroed when they grow. No other
    kernel shares them."""
    key = (q.device.index, stream)
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
    chunk order, in one launch; ``len1`` is never read on the host. Its
    scratch lives in a workspace kept per device and stream
    (``_split_workspace``)."""
    B, Hq, dh = q.shape
    rows, block, Hkv, dh_p = k_pool.shape
    if dh_p != dh or Hq % Hkv or v_pool.shape != k_pool.shape:
        raise ValueError(f"decode_paged: q {tuple(q.shape)} does not match "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if not rt.on_card(q, k_pool, v_pool, tables, len1):
        return decode_paged_ref(q, k_pool, v_pool, tables, len1)
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
    slot = -(-G * (dh + 2) // 4) * 4
    stream = rt.stream_ptr(q)
    part, count = _split_workspace(q, stream, B * Hkv * chunks * slot,
                                   B * Hkv)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), len1.data_ptr(), out.data_ptr(),
            part.data_ptr(), count.data_ptr(), B, Hkv, G, dh, block, maxb,
            1.0 / math.sqrt(dh), stream)
    rt.check_launch("decode_paged", rc)
    rt.count_launch("decode_paged")
    return out


def decode(q, k_cache, v_cache, length: int):
    """Dense-cache GQA decode: q (B,Hq,dh) against caches (B,S,Hkv,dh),
    attending positions ``< length`` (a host int shared by the batch, at
    least 1); the rest of the cache is never read. Returns (B,Hq,dh).

    CPU tensors take the plain version, in any float dtype; CUDA tensors
    launch the kernel, which takes bf16 q and caches."""
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
    G = Hq // Hkv
    if not q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16:
        raise TypeError(f"decode: dtypes q={q.dtype} k={k_cache.dtype} "
                        f"v={v_cache.dtype}; the kernel takes bf16 for all "
                        "three")
    _check_head_shape("decode", dh, G)
    rt.check_contiguous("decode", q=q, k_cache=k_cache, v_cache=v_cache)
    fn = rt.bind("flash_decode", "flash_decode_bf16", _DENSE_ARGS)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), B, S, Hkv, G, dh, length, 1.0 / math.sqrt(dh),
            rt.stream_ptr(q))
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
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name}: {k} needs a contiguous head_dim and "
                             "16-byte aligned rows")
        out.extend(t.stride()[:3])
    return out


def attention(q, k, v, *, causal=True, window=0):
    """Causal / sliding-window GQA attention over a whole prompt:
    q (B,S,Hq,dh), k/v (B,S,Hkv,dh) -> (B,S,Hq,dh). Query i attends key j
    where ``j <= i`` (causal) and ``i - j < window`` (window > 0). Any
    S >= 1; the BSHD tensors are read by their strides, so a slice of a
    larger buffer is taken as it is.

    CPU tensors take the plain version, in any float dtype; CUDA tensors
    launch the ``flash_prefill`` kernel, which takes bf16."""
    B, S, Hq, dh = q.shape
    if k.shape[:2] != (B, S) or k.shape[3] != dh or v.shape != k.shape \
            or Hq % k.shape[2]:
        raise ValueError(f"attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"attention: window {window} < 0")
    if not rt.on_card(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window)
    Hkv = k.shape[2]
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"attention: dtypes q={q.dtype} k={k.dtype} "
                        f"v={v.dtype}; the kernel takes bf16 for all three")
    if dh not in (32, 64, 128, 256):
        raise ValueError(f"attention: kernel takes dh in 32/64/128/256, got "
                         f"{dh}")
    strides = _row_strides("attention", q=q, k=k, v=v)
    fn = rt.bind("flash_prefill", "flash_prefill_bf16", _PREFILL_ARGS)
    out = torch.empty((B, S, Hq, dh), dtype=q.dtype, device=q.device)
    strides += out.stride()[:3]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            Hq, Hkv, dh, int(causal), int(window), *strides,
            1.0 / math.sqrt(dh), rt.stream_ptr(q))
    rt.check_launch("flash_prefill", rc)
    rt.count_launch("flash_prefill")
    return out
