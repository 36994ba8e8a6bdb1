"""Decoder-only transformer, the dense and moe families (counterpart of
those branches of ``repro.models.transformer``). Layer params are stacked
on a leading L axis and iterated with a Python loop; the per-layer K/V are
returned stacked, as the JAX scan emits them. A config with ``n_experts``
gives every layer the routed MoE FFN (``layers.moe_apply``) in place of the
dense one; ``_mlp`` is the one seam every plain body calls.

Serving with a dense cache: ``prefill`` fills a ``(L,B,max_len,Hkv,dh)``
bf16 cache ``{"k","v"}`` and ``decode_step`` extends it by one token at a
position shared by the batch, writing the cache in place (JAX returns a new
one). Under a sliding window W the cache is a ring of ``min(max_len, W)``
positions: position p lives at index ``p % W``; a prefill longer than W
keeps its last W positions, rolled into place.

The dense variants' branches follow JAX's: QKV and output biases, tied
embeddings (the token table as the head), LayerNorm, GELU and the RoPE
styles (``layers``), and a vision stub's ``patch_embeds``."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import spec


def _check_dense(cfg: ModelConfig):
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: this module runs the "
            "dense and moe families; MLA (mla_moe), xLSTM and "
            "encoder-decoder follow (ROADMAP.md Queue 1)")
    if cfg.first_dense_layers:
        raise NotImplementedError(
            "first_dense_layers (DeepSeek's dense head layers) comes with "
            "the MLA family (ROADMAP.md Queue 1)")


def _attn_specs(cfg: ModelConfig):
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "norm": L.norm_specs(cfg),
        "wq": spec((D, Hq, dh), ("embed", "q_heads", "head_dim")),
        "wk": spec((D, Hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": spec((D, Hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": spec((Hq, dh, D), ("q_heads", "head_dim", "embed"),
                   fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        p["bq"] = spec((Hq, dh), ("q_heads", "head_dim"), init="zeros")
        p["bk"] = spec((Hkv, dh), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = spec((Hkv, dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.attn_out_bias:
        p["bo"] = spec((D,), ("embed",), init="zeros")
    return p


def _stack(tree, n):
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return tree._replace(shape=(n,) + tree.shape, axes=("layers",) + tree.axes,
                         fan_in_axes=tuple(a + 1 for a in tree.fan_in_axes))


def param_specs(cfg: ModelConfig):
    _check_dense(cfg)
    layer = {"attn": _attn_specs(cfg), "mlp_norm": L.norm_specs(cfg),
             "mlp": L.moe_specs(cfg) if cfg.n_experts > 0
             else L.ffn_specs(cfg)}
    p = {
        "embed": {"tok": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                              fan_in_axes=())},
        "final_norm": L.norm_specs(cfg),
        "layers": _stack(layer, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return p


def layer_params(params, i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked ``params['layers']`` tree (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["layers"])


def qkv_proj(cfg, p, hn, positions):
    """q (B,S,Hq,dh), k, v (B,S,Hkv,dh) of the normed input ``hn``: the
    projections with the QKV biases, then RoPE on q and k. Also serves a
    rank's shard of the heads (the biases shard with them)."""
    q = torch.einsum("bsd,dhk->bshk", hn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", hn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", hn, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return L.apply_rope(cfg, q, positions), L.apply_rope(cfg, k, positions), v


def attn_out(cfg, p, o):
    """The attention block's output projection of o (B,S,Hq,dh), with its
    bias."""
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return y + p["bo"] if cfg.attn_out_bias else y


def _dense_attn(cfg, p, x, positions):
    h = L.apply_norm(cfg, p["norm"], x)
    q, k, v = qkv_proj(cfg, p, h, positions)
    o = L.attention(q, k, v, window=cfg.sliding_window)
    return x + attn_out(cfg, p, o), (k, v)


def _mlp(cfg, p_norm, p_mlp, x):
    """x plus the layer's FFN: the routed MoE where the config has experts
    (its capacity counts every token of x), else the dense one."""
    h = L.apply_norm(cfg, p_norm, x)
    if cfg.n_experts > 0:
        return x + L.moe_apply(cfg, p_mlp, h)
    return x + L.ffn_apply(cfg, p_mlp, h)


def _layer(cfg, lp, x, positions):
    x, kv = _dense_attn(cfg, lp["attn"], x, positions)
    return _mlp(cfg, lp["mlp_norm"], lp["mlp"], x), kv


def embed_tokens(cfg, params, tokens):
    return params["embed"]["tok"][tokens]


def unembed(cfg, params, h):
    """Logits of h (..., D): the head, or the token table where the
    embeddings are tied."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["tok"].t()
    return h @ params["lm_head"]


def forward(cfg: ModelConfig, params, batch, *, return_cache: bool = False,
            last_only: bool = False):
    """tokens (B,S) -> logits (B,S,V) (or (B,1,V) with ``last_only``); with
    ``return_cache`` also ``[(k, v)]`` with k/v ``(L,B,S,Hkv,dh)``. A
    vision config's ``batch["patch_embeds"]`` (B,P,D) replace the first P
    token embeddings (the frontend is a stub, as in JAX)."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = embed_tokens(cfg, params, tokens)
    if "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)
        h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, (k, v) = _layer(cfg, layer_params(params, i), h, positions)
        ks.append(k)
        vs.append(v)
    h = L.apply_norm(cfg, params["final_norm"], h)
    if last_only:
        h = h[:, -1:]
    logits = unembed(cfg, params, h)
    if return_cache:
        return logits, [(torch.stack(ks), torch.stack(vs))]
    return logits


# ---------------------------- serving --------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """``{name: (shape, dtype)}`` of the decode cache: ``min(max_len, W)``
    positions under a sliding window W (the ring)."""
    _check_dense(cfg)
    if cfg.sliding_window:
        max_len = min(max_len, cfg.sliding_window)
    sh = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (sh, torch.bfloat16), "v": (sh, torch.bfloat16)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return {k: torch.zeros(sh, dtype=dt, device=device)
            for k, (sh, dt) in cache_spec(cfg, batch, max_len).items()}


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, max_len: int):
    """Run the full forward over tokens (B,S); return (last-token logits
    (B,V), cache filled to S). Each layer's K/V go straight into the cache,
    so no stacked copy of all layers is held beside it. Under a window W
    with S > W the cache keeps the last W positions, rolled by ``(S - W) %
    W`` so that position p sits at ``p % W`` (a ring of W positions, as
    JAX's prefill returns it whatever ``max_len``). (``no_grad``, not
    ``inference_mode``: the cache is written in place afterwards.)"""
    _check_dense(cfg)
    B, S = tokens.shape
    W = cfg.sliding_window
    ring = bool(W) and S > W
    cache = init_cache(cfg, B, W if ring else max_len, tokens.device)
    h = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for i in range(cfg.n_layers):
        h, (k, v) = _layer(cfg, layer_params(params, i), h, positions)
        if ring:
            k, v = (torch.roll(t[:, S - W:], (S - W) % W, dims=1)
                    for t in (k, v))
        cache["k"][i, :, :k.shape[1]] = k
        cache["v"][i, :, :v.shape[1]] = v
    h = L.apply_norm(cfg, params["final_norm"], h[:, -1:])
    return unembed(cfg, params, h)[:, -1], cache


def _decode_dense_layer(cfg, lp, hh, kc, vc, idx, posv, valid):
    """One layer of the decode step; writes this token's K/V into the
    layer's caches kc/vc (B,S,Hkv,dh) at ``idx``, in place."""
    p = lp["attn"]
    hn = L.apply_norm(cfg, p["norm"], hh)
    q, k, v = qkv_proj(cfg, p, hn, posv)
    kc[:, idx] = k[:, 0]
    vc[:, idx] = v[:, 0]
    o = L.decode_attention(q, kc, vc, valid)
    hh = hh + attn_out(cfg, p, o)
    return _mlp(cfg, lp["mlp_norm"], lp["mlp"], hh), (kc, vc)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """tokens (B,1) int, ``pos`` host int (next position index, shared by
    the batch). Returns (logits (B,V), cache), the cache updated in place:
    at index ``pos``, or ``pos % S`` in a windowed ring of S positions,
    where the token attends the ``min(pos + 1, S)`` filled entries."""
    _check_dense(cfg)
    B = tokens.shape[0]
    S = cache["k"].shape[2]
    pos = int(pos)
    dev = tokens.device
    h = embed_tokens(cfg, params, tokens)
    posv = torch.full((B, 1), pos, dtype=torch.long, device=dev)
    idx = pos % S if cfg.sliding_window else pos
    valid = (torch.arange(S, device=dev) < min(pos + 1, S))[None].expand(B, S)
    for i in range(cfg.n_layers):
        h, _ = _decode_dense_layer(cfg, layer_params(params, i), h,
                                   cache["k"][i], cache["v"][i], idx, posv,
                                   valid)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h)[:, 0], cache
