"""Plain PyTorch versions of the attention kernels: prefill is the quadratic
oracle; the paged decode gathers the lanes' blocks into contiguous caches;
each takes a masked softmax in f32."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import decode_attention, naive_attention


def attention_ref(q, k, v, *, causal=True, window=0):
    """q (B,S,Hq,dh), k/v (B,S,Hkv,dh) -> (B,S,Hq,dh)."""
    return naive_attention(q, k, v, causal=causal, window=window)


def decode_paged_ref(q, k_pool, v_pool, tables, len1):
    """q (B,Hq,dh); pools (rows, block, Hkv, dh); tables (B, maxb) int;
    len1 (B,) int valid positions per lane. Returns (B,Hq,dh) in q.dtype.
    Scores, softmax and the value product are f32, as in the kernel."""
    B, Hq, dh = q.shape
    _, block, Hkv, _ = k_pool.shape
    G = Hq // Hkv
    maxb = tables.shape[1]
    S = maxb * block
    tl = tables.long()
    kc = k_pool[tl].reshape(B, S, Hkv, dh).float()
    vc = v_pool[tl].reshape(B, S, Hkv, dh).float()
    qg = q.reshape(B, Hkv, G, dh).float() * (1.0 / math.sqrt(dh))
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc)
    mask = torch.arange(S, device=q.device)[None, :] < len1.long()[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vc)
    return o.reshape(B, Hq, dh).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, length: int):
    """q (B,Hq,dh), caches (B,S,Hkv,dh), ``length`` host int: positions
    ``< length`` are attended, the rest never enter the softmax. Returns
    (B,Hq,dh) in q.dtype. Scores are f32 as in the kernel (the JAX oracle
    rounds bf16 scores to bf16 first); probabilities are cast to the cache's
    dtype for the value product."""
    B, S = k_cache.shape[:2]
    valid = (torch.arange(S, device=q.device) < int(length))[None]
    return decode_attention(q[:, None], k_cache, v_cache,
                            valid.expand(B, S))[:, 0]
