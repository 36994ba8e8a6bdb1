"""Decoder-only transformer, the dense, moe and mla_moe families
(counterpart of ``repro.models.transformer``). Layer params are stacked on
a leading L axis and iterated with a Python loop; the per-layer K/V are
returned stacked, as the JAX scan emits them. A config with ``n_experts``
gives every layer of the ``layers`` stack the routed MoE FFN
(``layers.moe_apply``) in place of the dense one; ``first_dense_layers``
(DeepSeek's dense head layers) puts that many dense-FFN layers in a stack
of their own, ``dense_layers``, run first (``layer_stacks``). ``_mlp`` is
the one seam every plain body calls.

Serving with a dense cache: ``prefill`` fills a ``(L,B,max_len,Hkv,dh)``
bf16 cache ``{"k","v"}`` and ``decode_step`` extends it by one token at a
position shared by the batch, writing the cache in place (JAX returns a new
one). Under a sliding window W the cache is a ring of ``min(max_len, W)``
positions: position p lives at index ``p % W``; a prefill longer than W
keeps its last W positions, rolled into place.

MLA (``mla_moe``, DeepSeek-V2): the prefill expands the compressed KV
``c_kv`` (``kv_lora_rank`` wide) into per-head K of ``qk_nope_dim +
qk_rope_dim`` and V of ``v_head_dim`` and attends with ``layers.attention``
(on the card ``flash_prefill`` at dk 192, dv 128); the cache holds only
``c_kv`` and the shared rotated ``k_rope`` a position (``{"ckv",
"krope"}``, and ``{"ckv0", "krope0"}`` for the dense head layers), and a
decode step attends in the latent space with W_UK and W_UV absorbed
(``_mla_attn_decode``), never re-expanding K/V.

The dense variants' branches follow JAX's: QKV and output biases, tied
embeddings (the token table as the head), LayerNorm, GELU and the RoPE
styles (``layers``), and a vision stub's ``patch_embeds``."""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.models.common import remat_call, spec, unstack


def _check_ported(cfg: ModelConfig):
    if cfg.family not in ("dense", "moe", "mla_moe"):
        raise ValueError(
            f"family {cfg.family!r}: this module runs the dense, moe and "
            "mla_moe families (models.get_model picks each family's module)")


def _check_cache(cfg: ModelConfig):
    """The dense K/V cache holds the ``layers`` stack only, as JAX's does:
    dense head layers have a cache only in the MLA family."""
    _check_ported(cfg)
    if cfg.first_dense_layers and cfg.family != "mla_moe":
        raise NotImplementedError(
            "first_dense_layers outside MLA: the dense K/V cache holds the "
            "stacked layers only (as JAX's cache_spec)")


def _attn_specs(cfg: ModelConfig):
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.family == "mla_moe":
        lora, nope, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.v_head_dim
        return {
            "norm": L.norm_specs(cfg),
            "wq": spec((D, Hq, nope + cfg.qk_rope_dim),
                       ("embed", "q_heads", "head_dim")),
            "w_dkv": spec((D, lora + cfg.qk_rope_dim), ("embed", "kv_lora")),
            "kv_norm": {"scale": spec((lora,), ("kv_lora",), init="ones")},
            "w_uk": spec((lora, Hq, nope), ("kv_lora", "q_heads", "head_dim")),
            "w_uv": spec((lora, Hq, dv), ("kv_lora", "q_heads", "head_dim")),
            "wo": spec((Hq, dv, D), ("q_heads", "head_dim", "embed"),
                       fan_in_axes=(0, 1)),
        }
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


def layer_stacks(cfg: ModelConfig):
    """``[(stack, layers, moe)]`` in the order the model runs them: the
    dense head layers (``first_dense_layers``, a dense FFN) as
    ``dense_layers``, then ``layers`` (the MoE FFN where the config has
    experts)."""
    stacks = [("dense_layers", cfg.first_dense_layers, False)] \
        if cfg.first_dense_layers else []
    return stacks + [("layers", cfg.n_layers - cfg.first_dense_layers,
                      cfg.n_experts > 0)]


def param_specs(cfg: ModelConfig):
    _check_ported(cfg)
    p = {
        "embed": {"tok": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                              fan_in_axes=())},
        "final_norm": L.norm_specs(cfg),
    }
    for stack, n, moe in layer_stacks(cfg):
        p[stack] = _stack({"attn": _attn_specs(cfg),
                           "mlp_norm": L.norm_specs(cfg),
                           "mlp": L.moe_specs(cfg) if moe
                           else L.ffn_specs(cfg)}, n)
    if not cfg.tie_embeddings:
        p["lm_head"] = spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return p


def layer_params(params, i: int, stack: str = "layers") -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked ``params[stack]`` tree (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params[stack])


def layers_in_order(cfg: ModelConfig, params):
    """``(stack, i, layer params, moe)`` of every layer, in order (the
    stacks' ``unstack`` views)."""
    for stack, n, moe in layer_stacks(cfg):
        for i, lp in enumerate(unstack(params[stack])):
            yield stack, i, lp, moe


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


def _normed(cfg, p_norm, x):
    """The norm of the residual x, whole along S on a mesh with
    Megatron-SP (``ctx.gather_sequence``), for the projections after it."""
    return ctx.gather_sequence(L.apply_norm(cfg, p_norm, x))


def _residual(x, y):
    """x plus a block's output y, y first placed as the residual is
    (``ctx.constrain``: with Megatron-SP the partial sums of the
    row-parallel projection reduce-scattered over S; without it, on a
    mesh, reduced to the residual's placement, so that every layer takes
    its input in one placement, as a scan's carry keeps one)."""
    return x + ctx.constrain(y, like=x)


def _dense_attn(cfg, p, x, positions):
    h = _normed(cfg, p["norm"], x)
    q, k, v = qkv_proj(cfg, p, h, positions)
    o = L.attention(q, k, v, window=cfg.sliding_window)
    return _residual(x, attn_out(cfg, p, o)), (k, v)


def _mla_attn(cfg, p, x, positions):
    """Prefill / forward MLA: the compressed KV expanded to per-head K
    (nope + rope) and V, attended by ``layers.attention`` at dk = nope +
    rope, dv = ``v_head_dim`` (scale 1/sqrt(dk)). Returns (x + y, (c_kv
    (B,S,lora), k_rope (B,S,rope))), the layer's cache entries."""
    B, S, _ = x.shape
    nope, rope, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    h = _normed(cfg, p["norm"], x)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    q_rope = L.apply_rope(cfg, q[..., nope:], positions)
    ckv_full = h @ p["w_dkv"]                                  # (B,S,lora+rope)
    c_kv = L.rms_norm(ckv_full[..., :lora], p["kv_norm"]["scale"])
    k_rope = L.apply_rope(cfg, ckv_full[..., None, lora:], positions)
    k_nope = torch.einsum("bsc,chk->bshk", c_kv, p["w_uk"])
    # q, k and v whole (B,S,H,d) tensors: the kernel reads each through a
    # TMA map of its strides, a head's values contiguous
    v = torch.einsum("bsc,chv->bshv", c_kv, p["w_uv"]).contiguous()
    k = torch.cat([k_nope, k_rope.expand(B, S, cfg.n_heads, rope)], dim=-1)
    q = torch.cat([q[..., :nope], q_rope], dim=-1)
    o = L.attention(q, k, v)
    y = torch.einsum("bshv,hvd->bsd", o, p["wo"])
    return _residual(x, y), (c_kv, k_rope[:, :, 0])


def _mla_attn_decode(cfg, p, x, ckv_cache, krope_cache, pos: int):
    """Absorbed MLA decode of x (B,1,D) at host position ``pos``: x plus
    the output projection of ``_mla_decode_context`` of its norm."""
    h = L.apply_norm(cfg, p["norm"], x)                        # (B,1,D)
    c = _mla_decode_context(cfg, p, h, ckv_cache, krope_cache, pos)
    return _residual(x, torch.einsum("bhv,hvd->bd", c, p["wo"])[:, None])


def _mla_decode_context(cfg, p, h, ckv_cache, krope_cache, pos: int):
    """The absorbed attention of the normed h (B,1,D) at ``pos``: writes
    this token's c_kv and k_rope into the layer's caches (B,S,lora) /
    (B,S,rope) at ``pos``, in place, and attends their first ``pos + 1``
    entries (JAX masks the rest of S: the same function) in the latent
    space: q_nope through W_UK, scores in f32 (bf16 products summed in f32,
    JAX's ``preferred_element_type``), probabilities cast to the cache's
    type for the latent value product, then W_UV. Returns the per-head
    context (B,H,dv) before the output projection."""
    B = h.shape[0]
    nope, lora = cfg.qk_nope_dim, cfg.kv_lora_rank
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    posv = torch.full((B, 1), pos, dtype=torch.long, device=h.device)
    q_rope = L.apply_rope(cfg, q[..., nope:], posv)
    ckv_full = h[:, 0] @ p["w_dkv"]                            # (B,lora+rope)
    ckv_cache[:, pos] = L.rms_norm(ckv_full[:, :lora], p["kv_norm"]["scale"])
    krope_cache[:, pos] = L.apply_rope(cfg, ckv_full[:, None, None, lora:],
                                       posv)[:, 0, 0]
    ckv, kr = ckv_cache[:, :pos + 1], krope_cache[:, :pos + 1]
    q_c = torch.einsum("bihn,chn->bihc", q[..., :nope], p["w_uk"])
    s = torch.einsum("bihc,bsc->bhs", q_c.float(), ckv.float())
    s = s + torch.einsum("bihr,bsr->bhs", q_rope.float(), kr.float())
    pattn = torch.softmax(s / math.sqrt(nope + cfg.qk_rope_dim), dim=-1)
    ctx_c = torch.einsum("bhs,bsc->bhc", pattn.to(ckv.dtype), ckv)
    return torch.einsum("bhc,chv->bhv", ctx_c, p["w_uv"])


def _mlp(cfg, p_norm, p_mlp, x, moe=None):
    """x plus the layer's FFN: the routed MoE where ``moe`` (by default,
    where the config has experts; its capacity counts every token of x),
    else the dense one."""
    h = _normed(cfg, p_norm, x)
    if moe is None:
        moe = cfg.n_experts > 0
    if moe:
        return _residual(x, L.moe_apply(cfg, p_mlp, h))
    return _residual(x, L.ffn_apply(cfg, p_mlp, h))


def _layer(cfg, lp, x, positions, moe=None):
    """One layer over a prompt: (x out, the layer's cache entries: (k, v),
    or MLA's (c_kv, k_rope))."""
    if cfg.family == "mla_moe":
        x, kv = _mla_attn(cfg, lp["attn"], x, positions)
    else:
        x, kv = _dense_attn(cfg, lp["attn"], x, positions)
    return _mlp(cfg, lp["mlp_norm"], lp["mlp"], x, moe), kv


def embed_tokens(cfg, params, tokens):
    """The token table's rows; a DTensor table through
    ``layers.sharded_embedding``."""
    if ctx.is_dtensor(params["embed"]["tok"]):
        return L.sharded_embedding(params["embed"]["tok"], tokens)
    return params["embed"]["tok"][tokens]


def unembed(cfg, params, h):
    """Logits of h (..., D): the head, or the token table where the
    embeddings are tied."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["tok"].t()
    return h @ params["lm_head"]


def forward(cfg: ModelConfig, params, batch, *, remat: bool = False,
            return_cache: bool = False, last_only: bool = False):
    """tokens (B,S) -> logits (B,S,V) (or (B,1,V) with ``last_only``); with
    ``return_cache`` also one pair a layer stack (``layer_stacks``), as
    JAX's: ``(k, v)`` with k/v ``(L,B,S,Hkv,dh)``, or MLA's ``(c_kv,
    k_rope)`` ``(L,B,S,lora)`` / ``(L,B,S,rope)``. A vision config's
    ``batch["patch_embeds"]`` (B,P,D) replace the first P token embeddings
    (the frontend is a stub, as in JAX). ``remat`` recomputes each layer in
    the backward (``common.remat_call``)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = embed_tokens(cfg, params, tokens)
    if "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)
        h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    caches: Dict[str, list] = {}
    for stack, _, lp, moe in layers_in_order(cfg, params):
        h = ctx.constrain(h)
        h, kv = remat_call(remat, _layer, cfg, lp, h, positions, moe)
        if return_cache:
            caches.setdefault(stack, []).append(kv)
    h = _normed(cfg, params["final_norm"], h)
    if last_only:
        h = h[:, -1:]
    logits = unembed(cfg, params, h)
    if return_cache:
        return logits, [tuple(torch.stack(t) for t in zip(*kvs))
                        for kvs in caches.values()]
    return logits


# ---------------------------- serving --------------------------------

def _cache_keys(cfg: ModelConfig, stack: str):
    """The cache entries of a layer stack: ``("k", "v")``, or MLA's
    ``("ckv", "krope")`` (``"ckv0"``, ``"krope0"`` for the dense head
    layers)."""
    if cfg.family == "mla_moe":
        sfx = "0" if stack == "dense_layers" else ""
        return "ckv" + sfx, "krope" + sfx
    return "k", "v"


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """``{name: (shape, dtype)}`` of the decode cache, bf16:
    ``(L,B,max_len,Hkv,dh)`` K and V, ``min(max_len, W)`` positions under
    a sliding window W (the ring); for MLA ``(L,B,max_len,kv_lora_rank)``
    c_kv and ``(L,B,max_len,qk_rope_dim)`` k_rope a layer stack."""
    _check_cache(cfg)
    if cfg.sliding_window:
        max_len = min(max_len, cfg.sliding_window)
    if cfg.family == "mla_moe":
        out = {}
        for stack, n, _ in layer_stacks(cfg):
            kc, kr = _cache_keys(cfg, stack)
            out[kc] = ((n, batch, max_len, cfg.kv_lora_rank), torch.bfloat16)
            out[kr] = ((n, batch, max_len, cfg.qk_rope_dim), torch.bfloat16)
        return out
    sh = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (sh, torch.bfloat16), "v": (sh, torch.bfloat16)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zeros of ``cache_spec``; on a mesh step, DTensors in its cache
    placements (``ctx.cache_zeros``)."""
    return {k: ctx.cache_zeros(k, sh, dt, device)
            for k, (sh, dt) in cache_spec(cfg, batch, max_len).items()}


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, max_len: int):
    """Run the full forward over tokens (B,S); return (last-token logits
    (B,V), cache filled to S). Each layer's cache entries (K/V, or MLA's
    c_kv / k_rope) go straight into the cache, so no stacked copy of all
    layers is held beside it. Under a window W with S > W the cache keeps
    the last W positions, rolled by ``(S - W) % W`` so that position p
    sits at ``p % W`` (a ring of W positions, as JAX's prefill returns it
    whatever ``max_len``). (``no_grad``, not ``inference_mode``: the cache
    is written in place afterwards.)"""
    _check_cache(cfg)
    B, S = tokens.shape
    W = cfg.sliding_window
    ring = bool(W) and S > W
    cache = init_cache(cfg, B, W if ring else max_len, tokens.device)
    h = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for stack, i, lp, moe in layers_in_order(cfg, params):
        h, (a, b) = _layer(cfg, lp, h, positions, moe)
        if ring:
            a, b = (torch.roll(t[:, S - W:], (S - W) % W, dims=1)
                    for t in (a, b))
        ka, kb = _cache_keys(cfg, stack)
        cache[ka][i, :, :a.shape[1]] = a
        cache[kb][i, :, :b.shape[1]] = b
    h = L.apply_norm(cfg, params["final_norm"], h[:, -1:])
    return unembed(cfg, params, h)[:, -1], cache


def _decode_dense_layer(cfg, lp, hh, kc, vc, idx, posv, valid):
    """One layer of the decode step; writes this token's K/V into the
    layer's caches kc/vc (B,S,Hkv,dh) at ``idx``, in place, and attends
    them in the named ``cache_kv`` placement (the mesh decode step's; the
    cache's own, so no data moves)."""
    p = lp["attn"]
    hn = L.apply_norm(cfg, p["norm"], hh)
    q, k, v = qkv_proj(cfg, p, hn, posv)
    kc[:, idx] = k[:, 0]
    vc[:, idx] = v[:, 0]
    o = L.decode_attention(q, ctx.constrain_named("cache_kv", kc),
                           ctx.constrain_named("cache_kv", vc), valid)
    hh = _residual(hh, attn_out(cfg, p, o))
    return _mlp(cfg, lp["mlp_norm"], lp["mlp"], hh), (kc, vc)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """tokens (B,1) int, ``pos`` host int (next position index, shared by
    the batch). Returns (logits (B,V), cache), the cache updated in place:
    at index ``pos``, or ``pos % S`` in a windowed ring of S positions,
    where the token attends the ``min(pos + 1, S)`` filled entries; MLA
    attends the first ``pos + 1`` entries of its latent cache."""
    _check_cache(cfg)
    B = tokens.shape[0]
    pos = int(pos)
    dev = tokens.device
    h = embed_tokens(cfg, params, tokens)
    if cfg.family == "mla_moe":
        for stack, i, lp, moe in layers_in_order(cfg, params):
            kc, kr = _cache_keys(cfg, stack)
            h = _mla_attn_decode(cfg, lp["attn"], h, cache[kc][i],
                                 cache[kr][i], pos)
            h = _mlp(cfg, lp["mlp_norm"], lp["mlp"], h, moe)
    else:
        S = cache["k"].shape[2]
        posv = torch.full((B, 1), pos, dtype=torch.long, device=dev)
        idx = pos % S if cfg.sliding_window else pos
        valid = (torch.arange(S, device=dev)
                 < min(pos + 1, S))[None].expand(B, S)
        # PerfOptions.decode_cache_carry: JAX threads the stacked cache
        # through its layer scan as a carry, updating each layer's slice in
        # place, where it otherwise scans the slices out and stacks them
        # anew. This loop writes each layer's slice of the one stacked cache
        # in place whatever the field says, which is the carry's form: on
        # and off give the same bits (tests/test_torch_dense_decode.py).
        # MLA's branch takes no such field, as JAX's does not.
        for i in range(cfg.n_layers):
            h, _ = _decode_dense_layer(cfg, layer_params(params, i), h,
                                       cache["k"][i], cache["v"][i], idx,
                                       posv, valid)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h)[:, 0], cache
