"""Bucketed, packed prefill for the serving engine (counterpart of
``repro.serving.prefill``).

Several prompts ride in one ``(1, bucket)`` forward: the causal mask is
blocked across segments and RoPE positions restart per segment, so each
prompt's logits and K/V match its own sequential forward. Pad positions get
their own segment id (they attend at least themselves, so no softmax row is
fully masked) and scatter to the pool's scratch block. Buckets are powers of
two, as in the JAX package; PyTorch runs eagerly, so the JAX package's
ahead-of-time warmup and its compile accounting have no counterpart here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


# ----------------------------------------------------------------------
# Buckets and packing plans (verbatim from the JAX package)
# ----------------------------------------------------------------------

def default_buckets(max_len: int, min_bucket: int = 16) -> Tuple[int, ...]:
    """Power-of-two buckets ``min_bucket, 2*min_bucket, ...`` up to the
    first bucket covering ``max_len``."""
    if max_len < 1:
        raise ValueError("max_len must be >= 1")
    out = [min_bucket]
    while out[-1] < max_len:
        out.append(out[-1] * 2)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket covering ``n`` tokens."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} tokens exceed the largest bucket {buckets[-1]}")


def plan_packs(lengths: Sequence[int], buckets: Sequence[int],
               max_segments: int) -> List[List[int]]:
    """Greedy in-order chunking of prompt ``lengths`` into packed prefill
    calls: consecutive prompts share a call while their total fits the
    largest bucket and the segment count stays within ``max_segments``."""
    cap = buckets[-1]
    chunks: List[List[int]] = []
    cur: List[int] = []
    total = 0
    for i, n in enumerate(lengths):
        if n > cap:
            raise ValueError(f"prompt {i} ({n} tokens) exceeds bucket cap {cap}")
        if cur and (total + n > cap or len(cur) >= max_segments):
            chunks.append(cur)
            cur, total = [], 0
        cur.append(i)
        total += n
    if cur:
        chunks.append(cur)
    return chunks


# ----------------------------------------------------------------------
# The packed forward
# ----------------------------------------------------------------------

def packed_attention(q, k, v, seg):
    """Causal attention blocked across segments: query ``i`` attends key
    ``j`` iff ``j <= i`` and both carry the same segment id. q (B,Sq,Hq,dh),
    k/v (B,Sk,Hkv,dh), seg (B,Sq) int. Scores and softmax in f32; the
    probabilities are cast to v's dtype for the value product."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = (kpos <= qpos) & (seg[0][:, None] == seg[0][None, :])
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, dv)


def packed_prefill_fn(cfg: ModelConfig):
    """``f(params, tokens (1,S), seg (1,S), pos (1,S), last_idx (P,)) ->
    (logits (P,V), k (L,S,Hkv,dh), v (L,S,Hkv,dh))``: the dense layer math of
    ``models.transformer`` with the segment mask and explicit positions."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    def _attn(p, x, seg, pos):
        h = L.apply_norm(cfg, p["norm"], x)
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
        q = L.apply_rope(cfg, q, pos)
        k = L.apply_rope(cfg, k, pos)
        o = packed_attention(q, k, v, seg)
        y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
        return x + y, (k, v)

    def forward(params, tokens, seg, pos, last_idx):
        h = T.embed_tokens(cfg, params, tokens)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = T.layer_params(params, i)
            h, (k, v) = _attn(lp["attn"], h, seg, pos)
            h = T._mlp(cfg, lp["mlp_norm"], lp["mlp"], h)
            ks.append(k[0])
            vs.append(v[0])
        h = L.apply_norm(cfg, params["final_norm"], h)
        logits = T.unembed(cfg, params, h[0][last_idx])      # (P, V)
        return logits, torch.stack(ks), torch.stack(vs)

    return forward


# ----------------------------------------------------------------------
# The runner
# ----------------------------------------------------------------------

@dataclass
class PackedPrefill:
    """Result of one packed prefill call. ``logits`` rows beyond
    ``len(spans)`` are padding; ``k``/``v`` are the packed caches."""
    logits: torch.Tensor                 # (max_segments, V)
    k: torch.Tensor                      # (L, S, Hkv, dh)
    v: torch.Tensor
    spans: List[Tuple[int, int]]         # per prompt: (offset, length)
    bucket: int


class PackedPrefillRunner:
    """Bucketed packed prefill for one backbone config, shared by every
    expert of the composition."""

    def __init__(self, cfg: ModelConfig, *, buckets: Sequence[int],
                 max_segments: int = 8):
        if cfg.family != "dense":
            raise ValueError("packed prefill supports the dense family only")
        if cfg.sliding_window:
            raise ValueError("packed prefill does not support sliding windows")
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError("buckets must be strictly increasing")
        if max_segments < 1:
            raise ValueError("max_segments must be >= 1")
        self.cfg = cfg
        self.buckets = tuple(int(b) for b in buckets)
        self.max_segments = int(max_segments)
        self._fn = packed_prefill_fn(cfg)

    def pack(self, prompts: Sequence[np.ndarray]):
        """Packed host arrays for one call: tokens, segment ids (pad =
        ``max_segments``), per-segment restarting positions, last-token
        indices padded with 0, and the chosen bucket."""
        if not prompts:
            raise ValueError("pack: empty prompt list")
        if len(prompts) > self.max_segments:
            raise ValueError(
                f"pack: {len(prompts)} prompts > max_segments "
                f"{self.max_segments}")
        lens = [len(p) for p in prompts]
        bucket = bucket_for(sum(lens), self.buckets)
        toks = np.zeros((1, bucket), np.int64)
        seg = np.full((1, bucket), self.max_segments, np.int64)
        pos = np.zeros((1, bucket), np.int64)
        last = np.zeros((self.max_segments,), np.int64)
        spans: List[Tuple[int, int]] = []
        off = 0
        for i, p in enumerate(prompts):
            n = len(p)
            toks[0, off:off + n] = p
            seg[0, off:off + n] = i
            pos[0, off:off + n] = np.arange(n)
            last[i] = off + n - 1
            spans.append((off, n))
            off += n
        pos[0, off:] = np.arange(bucket - off)
        return toks, seg, pos, last, spans, bucket

    @torch.inference_mode()
    def __call__(self, params, prompts: Sequence[np.ndarray]) -> PackedPrefill:
        """Run one packed prefill over ``prompts`` (1-D int token arrays)."""
        toks, seg, pos, last, spans, bucket = self.pack(prompts)
        dev = params["embed"]["tok"].device
        logits, k, v = self._fn(params, *(torch.as_tensor(a, device=dev)
                                          for a in (toks, seg, pos, last)))
        return PackedPrefill(logits=logits, k=k, v=v, spans=spans,
                             bucket=bucket)

    def scatter_into(self, pool, res: PackedPrefill, rids: Sequence[int],
                     extra_tokens: Optional[Sequence[int]] = None) -> None:
        """Open each ``rid`` in ``pool``, reserve its span (plus
        ``extra_tokens[i]`` future decode tokens), commit the span length,
        and land the whole packed K/V with one scatter. Pad positions (and
        nothing else) write the scratch block."""
        if len(rids) != len(res.spans):
            raise ValueError("rids/spans length mismatch")
        scratch = pool.scratch_index if pool.scratch_index is not None else 0
        rows = np.full((res.bucket,), scratch, np.int64)
        offs = np.zeros((res.bucket,), np.int64)
        for j, (rid, (off, n)) in enumerate(zip(rids, res.spans)):
            pool.open(rid)
            pool.reserve(rid, n + (extra_tokens[j] if extra_tokens else 0))
            tbl = np.asarray(pool.table(rid), np.int64)
            t = np.arange(n)
            rows[off:off + n] = tbl[t // pool.block]
            offs[off:off + n] = t % pool.block
            pool.advance(rid, n)
        self.scatter(pool, res, rows, offs)

    def scatter(self, pool, res: PackedPrefill, rows: np.ndarray,
                offs: np.ndarray) -> None:
        """Scatter the packed K/V into the pool in place. ``rows``/``offs``
        are (bucket,) — the pool row/offset of every packed position; pad
        positions must point at the scratch block. Pad positions that share
        the scratch block overwrite each other there; nothing reads them."""
        r = torch.as_tensor(rows, device=pool.k.device)
        o = torch.as_tensor(offs, device=pool.k.device)
        pool.k[:, r, o] = res.k.to(pool.k.dtype)
        pool.v[:, r, o] = res.v.to(pool.v.dtype)
