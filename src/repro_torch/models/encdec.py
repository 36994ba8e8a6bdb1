"""Encoder-decoder family, the Whisper-small backbone (counterpart of
``repro.models.encdec``).

The audio frontend (the mel conv stack) is a stub, as in JAX: the encoder
takes precomputed frame embeddings (B, encoder_seq, D). Positions are
sinusoidal. Layer params are stacked on a leading L axis (``enc_layers``,
``dec_layers``) and iterated with Python loops. Every attention of the
encoder and of the decoder's forward and prefill goes through
``layers.attention``, so on the card through ``flash_prefill``: the
encoder's self-attention (not causal, S = encoder_seq), the decoder's
causal self-attention and its cross-attention, where Sq decoder tokens
attend Sk = encoder_seq frames. A decode step attends with the plain
``layers.decode_attention``, as JAX's XLA does: its own cache up to
``pos`` and all the encoder frames.

Serving with a dense cache: ``prefill`` fills a ``(L,B,max_len,H,dh)``
self cache ``{"k","v"}`` at ``[:S]`` and the cross K/V ``{"cross_k",
"cross_v"}`` ``(L,B,encoder_seq,H,dh)``, each layer's entries written
straight into the cache (its dtype, bf16 as JAX's ``cache_spec``);
``decode_step`` writes the self cache in place at ``pos`` (JAX returns a
new one).

On a mesh (DTensors, the mesh builders of ``distributed.stepfn``) the
token table is looked up through ``layers.sharded_embedding`` and each
attention runs each rank's shard through ``local_map`` (``layers.
attention``); the cache is made in the step's cache placements
(``ctx.cache_zeros``), and a decode step attends its self cache in the
named ``cache_kv`` placement, as JAX's constrains it. As in JAX, no
activation is sharded over the sequence."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.models.common import remat_call, spec, unstack
from repro_torch.models.transformer import _stack, embed_tokens, layer_params


def _check_encdec(cfg: ModelConfig):
    if cfg.family != "encdec" or not cfg.n_encoder_layers \
            or not cfg.encoder_seq:
        raise ValueError(f"{cfg.name!r} is not an encdec config with "
                         "encoder layers and an encoder length")


def sinusoid_pos(S, D, device=None):
    """(S, D) bf16 sinusoids at positions ``arange(S)`` (S an int) or at
    the given positions (a 1-D array or tensor): sin then cos of
    position * 10000^(-2i/D). The inverse frequencies in float64 numpy, cast
    to f32, multiplied in f32, as the JAX function does."""
    pos = torch.arange(S, device=device) if isinstance(S, int) \
        else torch.as_tensor(S, device=device)
    inv = 1.0 / (10000 ** (np.arange(0, D, 2) / D))
    ang = pos.float()[:, None] * torch.as_tensor(inv.astype(np.float32),
                                                 device=pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)],
                     dim=-1).to(torch.bfloat16)


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig):
    """Whisper's attention: as many K/V heads as q heads; biases on q and
    v only (JAX's ``bq`` / ``bv``, no ``bk``) and on the output."""
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    p = {
        "norm": L.norm_specs(cfg),
        "wq": spec((D, H, dh), ("embed", "q_heads", "head_dim")),
        "wk": spec((D, H, dh), ("embed", "kv_heads", "head_dim")),
        "wv": spec((D, H, dh), ("embed", "kv_heads", "head_dim")),
        "wo": spec((H, dh, D), ("q_heads", "head_dim", "embed"),
                   fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        p["bq"] = spec((H, dh), ("q_heads", "head_dim"), init="zeros")
        p["bv"] = spec((H, dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.attn_out_bias:
        p["bo"] = spec((D,), ("embed",), init="zeros")
    return p


def param_specs(cfg: ModelConfig):
    _check_encdec(cfg)
    enc_layer = {"attn": _attn_specs(cfg), "mlp_norm": L.norm_specs(cfg),
                 "mlp": L.ffn_specs(cfg)}
    dec_layer = {"self_attn": _attn_specs(cfg),
                 "cross_attn": _attn_specs(cfg),
                 "mlp_norm": L.norm_specs(cfg), "mlp": L.ffn_specs(cfg)}
    return {
        "embed": {"tok": spec((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), fan_in_axes=())},
        "enc_layers": _stack(enc_layer, cfg.n_encoder_layers),
        "enc_final_norm": L.norm_specs(cfg),
        "dec_layers": _stack(dec_layer, cfg.n_layers),
        "final_norm": L.norm_specs(cfg),
    }


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------

def _proj_qkv(cfg: ModelConfig, p, xq, xkv):
    """q (B,Sq,H,dh) of ``xq``; k, v (B,Sk,H,dh) of ``xkv``; q and v take
    their biases."""
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"])
    if cfg.qkv_bias:
        q, v = q + p["bq"], v + p["bv"]
    return q, k, v


def _out(cfg: ModelConfig, p, o):
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return y + p["bo"] if cfg.attn_out_bias else y


def _add(h, y):
    """The residual h plus a block's output y: on a mesh y's partial sums
    reduced to h's placement first (``ctx.reduce_like``), so that every
    layer takes its input in one placement, as a scan's carry keeps one."""
    return h + ctx.reduce_like(y, h)


def _mlp(cfg: ModelConfig, lp, h):
    return _add(h, L.ffn_apply(cfg, lp["mlp"],
                               L.apply_norm(cfg, lp["mlp_norm"], h)))


def _enc_layer(cfg: ModelConfig, lp, h):
    hn = L.apply_norm(cfg, lp["attn"]["norm"], h)
    q, k, v = _proj_qkv(cfg, lp["attn"], hn, hn)
    h = _add(h, _out(cfg, lp["attn"], L.attention(q, k, v, causal=False)))
    return _mlp(cfg, lp, h)


def encode(cfg: ModelConfig, params, enc_embeds, *, remat=False):
    """enc_embeds (B,Se,D) -> the encoder's output (B,Se,D): the frames in
    bf16 plus their sinusoids, then pre-norm layers of self-attention (not
    causal) and the GELU MLP, then the final LayerNorm. ``remat``
    recomputes each layer in the backward (``common.remat_call``)."""
    _check_encdec(cfg)
    B, S, D = enc_embeds.shape
    h = enc_embeds.to(torch.bfloat16) + sinusoid_pos(
        S, D, enc_embeds.device)[None]
    for lp in unstack(params["enc_layers"]):
        h = remat_call(remat, _enc_layer, cfg, lp, h)
    return L.apply_norm(cfg, params["enc_final_norm"], h)


def _dec_layer(cfg: ModelConfig, lp, h, enc_out):
    """One decoder layer: (h out, its self (k, v), its cross (k, v))."""
    hn = L.apply_norm(cfg, lp["self_attn"]["norm"], h)
    q, k, v = _proj_qkv(cfg, lp["self_attn"], hn, hn)
    h = _add(h, _out(cfg, lp["self_attn"], L.attention(q, k, v,
                                                       causal=True)))
    hn = L.apply_norm(cfg, lp["cross_attn"]["norm"], h)
    qc, kc, vc = _proj_qkv(cfg, lp["cross_attn"], hn, enc_out)
    h = _add(h, _out(cfg, lp["cross_attn"], L.attention(qc, kc, vc,
                                                        causal=False)))
    return _mlp(cfg, lp, h), (k, v), (kc, vc)


def _decoder(cfg: ModelConfig, params, tokens, enc_out, *, cache=None,
             last_only=False, remat=False):
    """The decoder over tokens (B,S) attending ``enc_out``: logits
    (B,S,V), or (B,1,V) with ``last_only``. With ``cache`` (from
    ``init_cache``) each layer's self K/V is written at ``[:S]`` and its
    cross K/V whole. ``remat`` recomputes each layer in the backward."""
    B, S = tokens.shape
    h = embed_tokens(cfg, params, tokens) + sinusoid_pos(
        S, cfg.d_model, tokens.device)[None]
    for i, lp in enumerate(unstack(params["dec_layers"])):
        h, (k, v), (kc, vc) = remat_call(remat, _dec_layer, cfg, lp, h,
                                         enc_out)
        if cache is not None:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            cache["cross_k"][i] = kc
            cache["cross_v"][i] = vc
    h = L.apply_norm(cfg, params["final_norm"], h)
    if last_only:
        h = h[:, -1:]
    return torch.einsum("bsd,vd->bsv", h, params["embed"]["tok"])


def forward(cfg: ModelConfig, params, batch, *, remat=False, last_only=False):
    """batch {"enc_embeds" (B,Se,D), "tokens" (B,S)} -> logits (B,S,V)
    (or (B,1,V) with ``last_only``). ``remat`` recomputes each encoder and
    decoder layer in the backward (JAX's takes the flag and checkpoints
    nothing; the values are the same)."""
    enc_out = encode(cfg, params, batch["enc_embeds"], remat=remat)
    return _decoder(cfg, params, batch["tokens"], enc_out,
                    last_only=last_only, remat=remat)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """``{name: (shape, dtype)}`` of the decode cache, bf16: the self K/V
    ``(L,B,max_len,H,dh)`` and the cross K/V ``(L,B,encoder_seq,H,dh)``."""
    _check_encdec(cfg)
    Ld, H, dh, Se = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.encoder_seq
    bf16 = torch.bfloat16
    return {"k": ((Ld, batch, max_len, H, dh), bf16),
            "v": ((Ld, batch, max_len, H, dh), bf16),
            "cross_k": ((Ld, batch, Se, H, dh), bf16),
            "cross_v": ((Ld, batch, Se, H, dh), bf16)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zeros of ``cache_spec``; on a mesh step, DTensors in its cache
    placements (``ctx.cache_zeros``)."""
    return {k: ctx.cache_zeros(k, sh, dt, device)
            for k, (sh, dt) in cache_spec(cfg, batch, max_len).items()}


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, max_len: int):
    """Encode ``batch["enc_embeds"]``, run the decoder over
    ``batch["tokens"]`` (B,S); return (last-token logits (B,V), the cache
    with the self K/V at ``[:S]`` and the cross K/V)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(cfg, params, batch["enc_embeds"])
    cache = init_cache(cfg, B, max_len, tokens.device)
    logits = _decoder(cfg, params, tokens, enc_out, cache=cache,
                      last_only=True)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """tokens (B,1) int at position ``pos`` (a host int shared by the
    batch). Returns (logits (B,V), cache), the self cache written in place
    at ``pos``; the token attends its first ``pos + 1`` entries and every
    encoder frame."""
    _check_encdec(cfg)
    B = tokens.shape[0]
    pos = int(pos)
    dev = tokens.device
    S = cache["k"].shape[2]
    h = embed_tokens(cfg, params, tokens) + sinusoid_pos(
        torch.full((1,), pos, device=dev), cfg.d_model)[None]
    valid = (torch.arange(S, device=dev) < pos + 1)[None].expand(B, S)
    ev = torch.ones((B, cache["cross_k"].shape[2]), dtype=torch.bool,
                    device=dev)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, "dec_layers")
        p = lp["self_attn"]
        hn = L.apply_norm(cfg, p["norm"], h)
        q, k, v = _proj_qkv(cfg, p, hn, hn)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v[:, 0]
        h = _add(h, _out(cfg, p, L.decode_attention(
            q, ctx.constrain_named("cache_kv", kc),
            ctx.constrain_named("cache_kv", vc), valid)))
        p = lp["cross_attn"]
        hn = L.apply_norm(cfg, p["norm"], h)
        qc = torch.einsum("bsd,dhk->bshk", hn, p["wq"])
        if cfg.qkv_bias:
            qc = qc + p["bq"]
        h = _add(h, _out(cfg, p, L.decode_attention(
            qc, cache["cross_k"][i], cache["cross_v"][i], ev)))
        h = _mlp(cfg, lp, h)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return torch.einsum("bsd,vd->bsv", h, params["embed"]["tok"])[:, 0], cache
