"""Dense decoder-only transformer (counterpart of the dense branch of
``repro.models.transformer``). Layer params are stacked on a leading L axis
and iterated with a Python loop; the per-layer K/V are returned stacked,
as the JAX scan emits them."""
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
    o = L.naive_attention(q, k, v, window=cfg.sliding_window)
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
