"""RecurrentGemma / Griffin family (counterpart of ``repro.models.rglru``):
RG-LRU recurrent blocks and local attention.

The pattern ('rec', 'rec', 'attn') cycles over n_layers; the full groups are
stacked on a leading G axis, the remainder (38 = 12 * 3 + 2: two trailing
rec layers) on a second stack, and both are iterated with Python loops. In
forward and prefill the RG-LRU recurrence runs through ``kernels.lru_scan``
(the hand-written kernel on the card, where JAX runs ``associative_scan``)
and the local attention through ``layers.attention`` (``flash_prefill`` with
the window on the card). A decode step is the single fused recurrence step,
and attends with the plain ``layers.decode_attention`` against a ring of
``W = min(window, max_len)`` positions written in place at ``pos % W``.

On a mesh (DTensors, the mesh builders of ``distributed.stepfn``) the
recurrence runs each rank's shard through ``local_map`` (``sharded_lru_
scan``: the batch over the data axes, ``d_rnn`` over 'model'), as
``layers.sharded_attention`` runs attention. With Megatron-SP the
recurrent block, like the attention and MLP blocks, takes the whole
sequence: ``transformer._normed`` gathers its normed input and
``transformer._residual`` places its output as the residual is, so the
causal conv and the gates never see a sequence shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import remat_call, spec, unstack

_C_RGLRU = 8.0


def _check_rglru(cfg: ModelConfig):
    if cfg.family != "rglru" or not cfg.block_pattern or not cfg.sliding_window:
        raise ValueError(f"{cfg.name!r} is not an rglru config with a block "
                         "pattern and a local-attention window")


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

def _rec_specs(cfg: ModelConfig):
    D, Dr, cw = cfg.d_model, cfg.d_rnn, cfg.conv_width
    return {
        "norm": L.norm_specs(cfg),
        "w_gate": spec((D, Dr), ("embed", "rnn")),
        "w_branch": spec((D, Dr), ("embed", "rnn")),
        "conv_w": spec((cw, Dr), ("conv", "rnn"), fan_in_axes=(0,)),
        "conv_b": spec((Dr,), ("rnn",), init="zeros"),
        "w_rg": spec((Dr, Dr), ("rnn_in", "rnn")),
        "b_rg": spec((Dr,), ("rnn",), init="zeros"),
        "w_ig": spec((Dr, Dr), ("rnn_in", "rnn")),
        "b_ig": spec((Dr,), ("rnn",), init="zeros"),
        "lam": spec((Dr,), ("rnn",), init="ones"),
        "w_out": spec((Dr, D), ("rnn", "embed")),
    }


def _mlp_specs(cfg: ModelConfig):
    """An MLP with its own pre-norm."""
    return {"norm": L.norm_specs(cfg), "ffn": L.ffn_specs(cfg)}


def _group_counts(cfg: ModelConfig):
    plen = len(cfg.block_pattern)
    return cfg.n_layers // plen, cfg.n_layers % plen


def _n_rec(cfg: ModelConfig) -> int:
    return sum(1 for b in cfg.block_pattern if b == "rec")


def param_specs(cfg: ModelConfig):
    _check_rglru(cfg)
    G, tail = _group_counts(cfg)
    n_rec = _n_rec(cfg)
    group = {
        "rec": T._stack(_rec_specs(cfg), n_rec),
        "rec_mlp": T._stack(_mlp_specs(cfg), n_rec),
        "attn": T._attn_specs(cfg),
        "attn_mlp": _mlp_specs(cfg),
    }
    p = {
        "embed": {"tok": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                              fan_in_axes=())},
        "groups": T._stack(group, G),
        "final_norm": L.norm_specs(cfg),
        "lm_head": spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }
    if tail:
        if not all(b == "rec" for b in cfg.block_pattern[:tail]):
            raise ValueError("the tail of the block pattern must be rec")
        p["tail_rec"] = T._stack(_rec_specs(cfg), tail)
        p["tail_mlp"] = T._stack(_mlp_specs(cfg), tail)
    return p


# ----------------------------------------------------------------------
# RG-LRU block
# ----------------------------------------------------------------------

def causal_conv(u, w, b, state=None):
    """Depthwise causal conv, the sum of shifted products (no cuDNN).
    u (B,S,Dr), w (cw,Dr), state (B,cw-1,Dr) or None. Returns
    (y, new_state)."""
    B, S, Dr = u.shape
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((B, cw - 1, Dr), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)
    y = sum(ext[:, i:i + S] * w[i] for i in range(cw))
    new_state = ext[:, S:] if cw > 1 else state
    return y + b, new_state


def _lru_coeffs(p, u):
    r = torch.sigmoid((u @ p["w_rg"] + p["b_rg"]).float())
    i = torch.sigmoid((u @ p["w_ig"] + p["b_ig"]).float())
    log_a = -_C_RGLRU * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) * (
        i * u.float())
    return a, b


def sharded_lru_scan(a, b):
    """``lru_scan`` of DTensors a, b (B, S, Dr): each rank's local call
    (the kernel on the card, its plain version on the CPU) through
    ``local_map``, the batch sharded over the data axes and Dr over
    'model' where the axes divide them (the recurrence is independent per
    (batch, channel))."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = a.device_mesh
    B, _, Dr = a.shape
    data = Shard(0) if B % L._data_size(mesh) == 0 else Replicate()
    tp = L._model_size(mesh)
    pl = L._mesh_placements(mesh, data,
                            Shard(2) if tp > 1 and Dr % tp == 0
                            else Replicate())
    return local_map(lru_ops.lru_scan, out_placements=list(pl),
                     in_placements=(pl, pl), in_grad_placements=(pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(a, b)


def rec_block(cfg: ModelConfig, p, x, state=None):
    """x (B,S,D). state = {'h': (B,Dr), 'conv': (B,cw-1,Dr)} or None (a
    whole sequence from a zero state). Returns (y, new_state)."""
    h = T._normed(cfg, p["norm"], x)
    gate = F.gelu(h @ p["w_gate"], approximate="tanh")
    u = h @ p["w_branch"]
    conv_state = state["conv"] if state is not None else None
    u, new_conv = causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    a, b = _lru_coeffs(p, u)
    if state is None:
        hid = sharded_lru_scan(a, b) if ctx.is_dtensor(a) \
            else lru_ops.lru_scan(a, b)
        new_h = hid[:, -1]
    else:
        new_h = a[:, 0] * state["h"] + b[:, 0]
        hid = new_h[:, None]
    y = (gate * hid.to(gate.dtype)) @ p["w_out"]
    return T._residual(x, y), {"h": new_h, "conv": new_conv}


def _mlp_block(cfg: ModelConfig, pm, x):
    return T._mlp(cfg, pm["norm"], pm["ffn"], x)


# ----------------------------------------------------------------------
# forward / prefill / decode
# ----------------------------------------------------------------------

def _take(tree, i):
    """Slice ``i`` of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _stack_states(states):
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def _group_apply(cfg: ModelConfig, gp, x, positions):
    """One (rec, rec, attn) group over a whole sequence. Returns (x, the
    rec blocks' stacked states, the attention's (k, v))."""
    rec_states, kv, li = [], None, 0
    recs, mlps = unstack(gp["rec"]), unstack(gp["rec_mlp"])
    for kind in cfg.block_pattern:
        if kind == "rec":
            x, ns = rec_block(cfg, recs[li], x)
            x = _mlp_block(cfg, mlps[li], x)
            rec_states.append(ns)
            li += 1
        else:
            x, kv = T._dense_attn(cfg, gp["attn"], x, positions)
            x = _mlp_block(cfg, gp["attn_mlp"], x)
    return x, _stack_states(rec_states), kv


def _tail_layer(cfg: ModelConfig, rp, mp, h):
    h, ns = rec_block(cfg, rp, h)
    return _mlp_block(cfg, mp, h), ns


def forward(cfg: ModelConfig, params, batch, *, remat=False, last_only=False,
            return_states=False):
    """tokens (B,S) -> logits (B,S,V) (or (B,1,V) with ``last_only``); with
    ``return_states`` also (groups' rec states, stacked (k, v) of the
    attention blocks (G,B,S,Hkv,dh), the tail's rec states or None).
    ``remat`` recomputes each group and tail layer in the backward
    (``common.remat_call``)."""
    _check_rglru(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = T.embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    G, tail = _group_counts(cfg)
    rec, ks, vs = [], [], []
    for gp in unstack(params["groups"]) if G else ():
        h = ctx.constrain(h)
        h, rs, (k, v) = remat_call(remat, _group_apply, cfg, gp, h,
                                   positions)
        rec.append(rs)
        ks.append(k)
        vs.append(v)
    tail_states = None
    if tail:
        ts = []
        for rp, mp in zip(unstack(params["tail_rec"]),
                          unstack(params["tail_mlp"])):
            h = ctx.constrain(h)
            h, ns = remat_call(remat, _tail_layer, cfg, rp, mp, h)
            ts.append(ns)
        tail_states = _stack_states(ts)
    h = T._normed(cfg, params["final_norm"], h)
    if last_only:
        h = h[:, -1:]
    logits = h @ params["lm_head"]
    if return_states:
        return logits, (_stack_states(rec), (torch.stack(ks), torch.stack(vs)),
                        tail_states)
    return logits


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """``{name: (shape, dtype)}`` (nested) of the decode cache: the rec
    states (h in f32, the conv window in bf16) and a ring of
    ``W = min(window, max_len)`` K/V positions per attention block."""
    _check_rglru(cfg)
    G, tail = _group_counts(cfg)
    n_rec = _n_rec(cfg)
    W = min(cfg.sliding_window, max_len)
    bf, f32 = torch.bfloat16, torch.float32
    cw1 = cfg.conv_width - 1
    kv = ((G, batch, W, cfg.n_kv_heads, cfg.head_dim), bf)
    c = {
        "rec": {"h": ((G, n_rec, batch, cfg.d_rnn), f32),
                "conv": ((G, n_rec, batch, cw1, cfg.d_rnn), bf)},
        "k": kv,
        "v": kv,
    }
    if tail:
        c["tail"] = {"h": ((tail, batch, cfg.d_rnn), f32),
                     "conv": ((tail, batch, cw1, cfg.d_rnn), bf)}
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zeros of ``cache_spec``; on a mesh step, DTensors in its cache
    placements (``ctx.cache_zeros``)."""
    def zeros(tree, path):
        if isinstance(tree, dict):
            return {k: zeros(v, path + (k,)) for k, v in tree.items()}
        return ctx.cache_zeros(path, tree[0], tree[1], device)
    return zeros(cache_spec(cfg, batch, max_len), ())


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, max_len: int):
    """Run the forward over tokens (B,S); return (last-token logits (B,V),
    cache). Past the window the ring keeps the last W positions, rolled by
    ``(S - W) % W`` so that position p sits at ``p % W``."""
    B, S = tokens.shape
    logits, (rec_states, (k, v), tail_states) = forward(
        cfg, params, {"tokens": tokens}, last_only=True, return_states=True)
    cache = init_cache(cfg, B, max_len, tokens.device)
    cache["rec"]["h"] = rec_states["h"].float()
    cache["rec"]["conv"] = rec_states["conv"].to(torch.bfloat16)
    W = cache["k"].shape[2]
    if S > W:
        roll = (S - W) % W
        cache["k"] = torch.roll(k[:, :, S - W:], roll, dims=2).to(torch.bfloat16)
        cache["v"] = torch.roll(v[:, :, S - W:], roll, dims=2).to(torch.bfloat16)
    else:
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
    if tail_states is not None:
        cache["tail"]["h"] = tail_states["h"].float()
        cache["tail"]["conv"] = tail_states["conv"].to(torch.bfloat16)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """tokens (B,1) int, ``pos`` host int (next position, shared by the
    batch). Returns (logits (B,V), cache): the K/V rings are written in place
    at ``pos % W``; the rec states are new tensors, as JAX returns them."""
    _check_rglru(cfg)
    B = tokens.shape[0]
    pos = int(pos)
    dev = tokens.device
    h = T.embed_tokens(cfg, params, tokens)
    posv = torch.full((B, 1), pos, dtype=torch.long, device=dev)
    W = cache["k"].shape[2]
    valid = (torch.arange(W, device=dev) < min(pos + 1, W))[None].expand(B, W)
    G, tail = _group_counts(cfg)
    group_h, group_conv = [], []
    for g in range(G):
        gp = _take(params["groups"], g)
        hs, convs, li = [], [], 0
        for kind in cfg.block_pattern:
            if kind == "rec":
                st = {"h": cache["rec"]["h"][g, li],
                      "conv": cache["rec"]["conv"][g, li]}
                h, ns = rec_block(cfg, _take(gp["rec"], li), h, st)
                h = _mlp_block(cfg, _take(gp["rec_mlp"], li), h)
                hs.append(ns["h"])
                convs.append(ns["conv"])
                li += 1
            else:
                lp = {"attn": gp["attn"], "mlp_norm": gp["attn_mlp"]["norm"],
                      "mlp": gp["attn_mlp"]["ffn"]}
                h, _ = T._decode_dense_layer(cfg, lp, h, cache["k"][g],
                                             cache["v"][g], pos % W, posv,
                                             valid)
        group_h.append(torch.stack(hs))
        group_conv.append(torch.stack(convs))
    cache = dict(cache, rec={"h": torch.stack(group_h),
                             "conv": torch.stack(group_conv)})
    if tail:
        hs, convs = [], []
        for i in range(tail):
            st = {"h": cache["tail"]["h"][i], "conv": cache["tail"]["conv"][i]}
            h, ns = rec_block(cfg, _take(params["tail_rec"], i), h, st)
            h = _mlp_block(cfg, _take(params["tail_mlp"], i), h)
            hs.append(ns["h"])
            convs.append(ns["conv"])
        cache = dict(cache, tail={"h": torch.stack(hs),
                                  "conv": torch.stack(convs)})
    h = L.apply_norm(cfg, params["final_norm"], h)
    return (h @ params["lm_head"])[:, 0], cache
