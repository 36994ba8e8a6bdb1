"""Plain PyTorch versions of the attention kernels: prefill is the quadratic
oracle; the paged decode gathers the lanes' blocks into contiguous caches;
each takes a masked softmax in f32. ``decode_paged_split_ref`` is the paged
kernel's own arithmetic (chunks of positions, merged in chunk order), for
the tests and the card's checks."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import decode_attention, naive_attention


def attention_ref(q, k, v, *, causal=True, window=0):
    """q (B,S,Hq,dh), k/v (B,S,Hkv,dh) -> (B,S,Hq,dh)."""
    return naive_attention(q, k, v, causal=causal, window=window)


def split_inputs(q, k_pool, v_pool, tables, len1):
    """The lanes' scores s (B,Hkv,G,S) in f32 (q scaled by 1/sqrt(dh), keys
    gathered through the block tables), their values (B,S,Hkv,dh) in f32
    and the attended positions valid (B,S), ``t < len1``, for S = maxb *
    block."""
    B, Hq, dh = q.shape
    _, block, Hkv, _ = k_pool.shape
    S = tables.shape[1] * block
    tl = tables.long()
    kc = k_pool[tl].reshape(B, S, Hkv, dh).float()
    vc = v_pool[tl].reshape(B, S, Hkv, dh).float()
    qg = q.reshape(B, Hkv, Hq // Hkv, dh).float() * (1.0 / math.sqrt(dh))
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc)
    valid = torch.arange(S, device=q.device)[None, :] < len1.long()[:, None]
    return s, vc, valid


def decode_paged_ref(q, k_pool, v_pool, tables, len1):
    """q (B,Hq,dh); pools (rows, block, Hkv, dh); tables (B, maxb) int;
    len1 (B,) int valid positions per lane. Returns (B,Hq,dh) in q.dtype.
    Scores, softmax and the value product are f32, as in the kernel."""
    s, vc, valid = split_inputs(q, k_pool, v_pool, tables, len1)
    p = torch.softmax(s.masked_fill(~valid[:, None, None, :], float("-inf")),
                      dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vc)
    return o.reshape(q.shape).to(q.dtype)


def split_partials(s, vc, valid, chunk: int):
    """Each chunk's partial state, as one CTA of the kernel computes it:
    positions [c chunk, (c + 1) chunk) give m = max s, p = exp(s - m),
    l = sum p, acc = sum p v (f32) over their valid positions; a chunk
    with none has m = -inf, l = 0, acc = 0. Returns m, l (B,Hkv,G,n) and
    acc (B,Hkv,G,n,dh), n = ceil(S / chunk)."""
    B, Hkv, G, S = s.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    s = torch.nn.functional.pad(s.masked_fill(~valid[:, None, None, :],
                                              float("-inf")), (0, pad),
                                value=float("-inf"))
    v = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
    s = s.reshape(B, Hkv, G, n, chunk)
    m = s.amax(-1)
    p = torch.exp(s - m.masked_fill(m == float("-inf"), 0.0)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhgnc,bnchd->bhgnd", p,
                       v.reshape(B, n, chunk, Hkv, -1))
    return m, l, acc


def merge_partials(m, l, acc):
    """The chunks' partials merged in chunk order, as the kernel's last CTA
    of each (lane, head) does: M = max m_c, o = sum_c acc_c e^(m_c - M) /
    sum_c l_c e^(m_c - M). Returns (B,Hkv,G,dh) f32."""
    M = m.amax(-1, keepdim=True)
    e = torch.exp(m - M.masked_fill(M == float("-inf"), 0.0))
    lt = torch.zeros_like(m[..., 0])
    ot = torch.zeros_like(acc[..., 0, :])
    for c in range(m.shape[-1]):
        lt = lt + l[..., c] * e[..., c]
        ot = ot + acc[..., c, :] * e[..., c, None]
    return ot / lt.clamp_min(1e-30)[..., None]


def decode_paged_split_ref(q, k_pool, v_pool, tables, len1, chunk: int):
    """``decode_paged`` as the kernel computes it: each chunk of ``chunk``
    positions to its partial (m, l, acc) in f32, the partials merged in
    chunk order (``split_partials``, ``merge_partials``). Positions past
    maxb * block are not attended. Returns (B,Hq,dh) in q.dtype."""
    o = merge_partials(*split_partials(
        *split_inputs(q, k_pool, v_pool, tables, len1), chunk))
    return o.reshape(q.shape).to(q.dtype)


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
