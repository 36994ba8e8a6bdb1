"""Dense decoder-only transformer (counterpart of the dense branch of
``repro.models.transformer``). Layer params are stacked on a leading L axis
and iterated with a Python loop; the per-layer K/V are returned stacked,
as the JAX scan emits them.

Serving with a dense cache: ``prefill`` fills a ``(L,B,max_len,Hkv,dh)``
bf16 cache ``{"k","v"}`` and ``decode_step`` extends it by one token at a
position shared by the batch, writing the cache in place (JAX returns a new
one). Sliding-window configs are not ported (``ROADMAP.md`` Queue 1)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import spec


def _check_dense(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1)")
    if cfg.qkv_bias or cfg.attn_out_bias or cfg.tie_embeddings:
        raise NotImplementedError("biases / tied embeddings are not ported yet")


def _attn_specs(cfg: ModelConfig):
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "norm": L.norm_specs(cfg),
        "wq": spec((D, Hq, dh), ("embed", "q_heads", "head_dim")),
        "wk": spec((D, Hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": spec((D, Hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": spec((Hq, dh, D), ("q_heads", "head_dim", "embed"),
                   fan_in_axes=(0, 1)),
    }


def _stack(tree, n):
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return tree._replace(shape=(n,) + tree.shape, axes=("layers",) + tree.axes,
                         fan_in_axes=tuple(a + 1 for a in tree.fan_in_axes))


def param_specs(cfg: ModelConfig):
    _check_dense(cfg)
    layer = {"attn": _attn_specs(cfg), "mlp_norm": L.norm_specs(cfg),
             "mlp": L.ffn_specs(cfg)}
    return {
        "embed": {"tok": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                              fan_in_axes=())},
        "final_norm": L.norm_specs(cfg),
        "layers": _stack(layer, cfg.n_layers),
        "lm_head": spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


def layer_params(params, i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked ``params['layers']`` tree (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["layers"])


def _dense_attn(cfg, p, x, positions):
    h = L.apply_norm(cfg, p["norm"], x)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    q = L.apply_rope(cfg, q, positions)
    k = L.apply_rope(cfg, k, positions)
    o = L.attention(q, k, v, window=cfg.sliding_window)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return x + y, (k, v)


def _mlp(cfg, p_norm, p_mlp, x):
    h = L.apply_norm(cfg, p_norm, x)
    return x + L.ffn_apply(cfg, p_mlp, h)


def _layer(cfg, lp, x, positions):
    x, kv = _dense_attn(cfg, lp["attn"], x, positions)
    return _mlp(cfg, lp["mlp_norm"], lp["mlp"], x), kv


def embed_tokens(cfg, params, tokens):
    return params["embed"]["tok"][tokens]


def unembed(cfg, params, h):
    return h @ params["lm_head"]


def forward(cfg: ModelConfig, params, batch, *, return_cache: bool = False,
            last_only: bool = False):
    """tokens (B,S) -> logits (B,S,V) (or (B,1,V) with ``last_only``); with
    ``return_cache`` also ``[(k, v)]`` with k/v ``(L,B,S,Hkv,dh)``."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = embed_tokens(cfg, params, tokens)
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

def _check_no_window(cfg: ModelConfig):
    if cfg.sliding_window:
        raise NotImplementedError(
            "the dense cache's sliding-window ring buffer is not ported yet "
            "(ROADMAP.md Queue 1)")


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """``{name: (shape, dtype)}`` of the decode cache."""
    _check_dense(cfg)
    _check_no_window(cfg)
    sh = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (sh, torch.bfloat16), "v": (sh, torch.bfloat16)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return {k: torch.zeros(sh, dtype=dt, device=device)
            for k, (sh, dt) in cache_spec(cfg, batch, max_len).items()}


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, max_len: int):
    """Run the full forward over tokens (B,S); return (last-token logits
    (B,V), cache filled to S). Each layer's K/V go straight into the cache,
    so no stacked copy of all layers is held beside it. (``no_grad``, not
    ``inference_mode``: the cache is written in place afterwards.)"""
    _check_dense(cfg)
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, tokens.device)
    h = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for i in range(cfg.n_layers):
        h, (k, v) = _layer(cfg, layer_params(params, i), h, positions)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    h = L.apply_norm(cfg, params["final_norm"], h[:, -1:])
    return unembed(cfg, params, h)[:, -1], cache


def _decode_dense_layer(cfg, lp, hh, kc, vc, idx, posv, valid):
    """One layer of the decode step; writes this token's K/V into the
    layer's caches kc/vc (B,S,Hkv,dh) at ``idx``, in place."""
    p = lp["attn"]
    hn = L.apply_norm(cfg, p["norm"], hh)
    q = torch.einsum("bsd,dhk->bshk", hn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", hn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", hn, p["wv"])
    q = L.apply_rope(cfg, q, posv)
    k = L.apply_rope(cfg, k, posv)
    kc[:, idx] = k[:, 0]
    vc[:, idx] = v[:, 0]
    o = L.decode_attention(q, kc, vc, valid)
    hh = hh + torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return _mlp(cfg, lp["mlp_norm"], lp["mlp"], hh), (kc, vc)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """tokens (B,1) int, ``pos`` host int (next position index, shared by
    the batch). Returns (logits (B,V), cache), the cache updated in place."""
    _check_dense(cfg)
    _check_no_window(cfg)
    B = tokens.shape[0]
    S = cache["k"].shape[2]
    pos = int(pos)
    dev = tokens.device
    h = embed_tokens(cfg, params, tokens)
    posv = torch.full((B, 1), pos, dtype=torch.long, device=dev)
    valid = (torch.arange(S, device=dev) < min(pos + 1, S))[None].expand(B, S)
    for i in range(cfg.n_layers):
        h, _ = _decode_dense_layer(cfg, layer_params(params, i), h,
                                   cache["k"][i], cache["v"][i], pos, posv,
                                   valid)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h)[:, 0], cache
