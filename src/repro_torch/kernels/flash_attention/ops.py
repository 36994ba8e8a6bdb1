"""Wrapper of the paged decode kernel (counterpart of
``repro.kernels.flash_attention.ops.decode_paged``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ref import decode_paged_ref

_ARGS = [rt.P] * 6 + [rt.I] * 6 + [rt.F, rt.P]


def decode_paged(q, k_pool, v_pool, tables, len1):
    """Paged-native GQA decode: q (B,Hq,dh) against the block pools
    (rows, block, Hkv, dh). tables (B, maxb) int32, padded with the pool's
    scratch row (every entry must be a valid row); len1 (B,) int32 = valid
    positions per lane including this step's token. Returns (B,Hq,dh).

    CPU tensors take the plain version, in any float dtype; CUDA tensors
    launch the kernel, which takes bf16 q and pools."""
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
    if dh not in (32, 64, 128, 256) or G not in (1, 2, 4, 8):
        raise ValueError(f"decode_paged: kernel takes dh in 32/64/128/256 and "
                         f"G in 1/2/4/8, got dh={dh}, G={G}")
    rt.check_contiguous("decode_paged", q=q, k_pool=k_pool, v_pool=v_pool,
                        tables=tables, len1=len1)
    fn = rt.bind("decode_paged", "decode_paged_bf16", _ARGS)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), len1.data_ptr(), out.data_ptr(), B, Hkv, G, dh,
            block, tables.shape[1], 1.0 / math.sqrt(dh), rt.stream_ptr(q))
    rt.check_launch("decode_paged", rc)
    rt.count_launch("decode_paged")
    return out
