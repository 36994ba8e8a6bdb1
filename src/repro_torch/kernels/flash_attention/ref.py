"""Plain PyTorch version of the paged decode kernel: gather the lanes' blocks
into contiguous caches, masked softmax in f32."""
from __future__ import annotations

import math

import torch


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
