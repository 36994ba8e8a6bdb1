"""Plain PyTorch versions of the attention kernels: prefill is the quadratic
oracle; the paged decode gathers the lanes' blocks into contiguous caches;
each takes a masked softmax in f32. ``decode_paged_split_ref`` and
``decode_split_ref`` are the two decode kernels' own arithmetic (chunks of
positions, merged in chunk order), for the tests and the card's checks.
``attention_bwd_ref`` is the prefill's gradient by the explicit formulas,
in f32, for the tests and the card's checks of the backward kernel (no
path computes a gradient with it)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import decode_attention, naive_attention


def attention_ref(q, k, v, *, causal=True, window=0):
    """q (B,Sq,Hq,dk), k (B,Sk,Hkv,dk), v (B,Sk,Hkv,dv) -> (B,Sq,Hq,dv),
    scale 1/sqrt(dk); Sk != Sq only without a causal mask or a window."""
    return naive_attention(q, k, v, causal=causal, window=window)


def attention_mask(Sq, Sk, *, causal=True, window=0, device=None):
    """(Sq, Sk) bool, True where query i attends key j: ``j <= i``
    (causal) and ``i - j < window`` (window > 0)."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    return mask


def attention_bwd_masked(q, k, v, do, mask, di=None, rounded=False):
    """dq, dk, dv (f32, shaped as q, k, v) of o = softmax(q k^T / sqrt(dk)
    over ``mask``) v for the upstream gradient ``do`` (shaped as o), by the
    explicit formulas in f32: p the masked softmax, dv = p^T do, dp = do
    v^T, ds = p (dp - di), dq = ds k / sqrt(dk), dk = ds^T q / sqrt(dk),
    the G q heads of a kv head summed into its dk / dv. ``di`` (B, Hq, Sq)
    is rowsum(o * do) of this o unless given. With ``rounded``, at the
    backward kernels' bf16 rounding points: p and ds rounded before the
    products that take them, o (the forward's output) and dq, dk, dv
    rounded as they are stored."""
    r = (lambda t: t.to(torch.bfloat16).float()) if rounded else \
        (lambda t: t)
    B, Sq, Hq, dk = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(dk)
    qf = q.float().reshape(B, Sq, Hkv, G, dk)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, Hkv, G, dv)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    del s
    if di is None:
        o = r(torch.einsum("bhgqk,bkhd->bqhgd", r(p), vf))
        di = (o * dof).sum(-1).permute(0, 2, 3, 1)         # (B,Hkv,G,Sq)
        del o
    else:
        di = di.float().reshape(B, Hkv, G, Sq)
    dv_ = torch.einsum("bhgqk,bqhgd->bkhd", r(p), dof)
    ds = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = r(p * (ds - di[..., None]))
    del p
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk_ = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return r(dq.reshape(B, Sq, Hq, dk)), r(dk_), r(dv_)


def attention_bwd_ref(q, k, v, do, *, causal=True, window=0):
    """The gradient of ``attention_ref(q, k, v, causal=..., window=...)``
    for upstream ``do``: (dq, dk, dv) in f32 (``attention_bwd_masked``)."""
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal,
                          window=window, device=q.device)
    return attention_bwd_masked(q, k, v, do, mask)


def attention_lse_ref(q, k, v, *, causal=True, window=0):
    """(o, lse): ``attention_ref``'s output and each row's log-sum-exp of
    its scaled scores, (B, Hq, Sq) f32 (``attention_lse``'s plain version),
    for q (B,Sq,Hq,dk), k (B,Sk,Hkv,dk), v (B,Sk,Hkv,dv)."""
    B, Sq, Hq, dk = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(B, Sq, Hkv, Hq // Hkv, dk),
                     k.float()) * (1.0 / math.sqrt(dk))
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          device=q.device)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return (attention_ref(q, k, v, causal=causal, window=window),
            lse.reshape(B, Hq, Sq))


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


def split_partials(s, vc, valid, chunk: int, p_dtype=None):
    """Each chunk's partial state, as one CTA of the kernel computes it:
    positions [c chunk, (c + 1) chunk) give m = max s, p = exp(s - m),
    l = sum p, acc = sum p v (f32) over their valid positions, p rounded
    to ``p_dtype`` in the value product where given (the dense kernel
    rounds it to the cache's); a chunk with none has m = -inf, l = 0, acc =
    0. Returns m, l (B,Hkv,G,n) and acc (B,Hkv,G,n,dh), n = ceil(S /
    chunk)."""
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
    pv = p if p_dtype is None else p.to(p_dtype).float()
    acc = torch.einsum("bhgnc,bnchd->bhgnd", pv,
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


def dense_split_inputs(q, k_cache, v_cache, length: int):
    """The dense kernel's scores s (B,Hkv,G,L) in f32 (q k^T / sqrt(dh)),
    values (B,L,Hkv,dh) in f32 and valid (B,L), all True, over the first L
    = min(length, S) positions of the caches; nothing past them is read."""
    B, Hq, dh = q.shape
    Hkv = k_cache.shape[2]
    L = min(int(length), k_cache.shape[1])
    qg = q.reshape(B, Hkv, Hq // Hkv, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache[:, :L].float()) \
        * (1.0 / math.sqrt(dh))
    valid = torch.ones((B, L), dtype=torch.bool, device=q.device)
    return s, v_cache[:, :L].float(), valid


def decode_split_ref(q, k_cache, v_cache, length: int, chunk: int):
    """``decode`` as the kernel computes it: the first min(length, S)
    positions in chunks of ``chunk``, each chunk's partial (m, l, acc) in
    f32, p rounded to the cache's dtype for the value product, the
    partials merged in chunk order (``dense_split_inputs``,
    ``split_partials``, ``merge_partials``). Positions past ``length`` are
    never read. Returns (B,Hq,dh) in q.dtype."""
    o = merge_partials(*split_partials(
        *dense_split_inputs(q, k_cache, v_cache, length), chunk,
        p_dtype=v_cache.dtype))
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
