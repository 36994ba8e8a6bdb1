"""Shared layers of the model families (counterpart of
``repro.models.layers``): RMSNorm and LayerNorm, full / partial / m-RoPE,
attention (the quadratic oracle and the ``flash_prefill`` kernel's entry),
single-token attention against a dense cache, the SwiGLU / GeGLU / GELU
FFN with its optional biases, and the routed MoE FFN (top-k with capacity
drops and an optional shared expert).

On a mesh (DTensor params and activations, run by the mesh builders of
``distributed.stepfn`` under ``implicit_replication``) two functions
leave DTensor's sharding propagation: ``attention`` runs its kernel, or
the kernel's plain version, on each rank's shard through ``local_map``,
and ``moe_apply`` routes and dispatches through ``local_map`` too (DTensor
has no rule for its sort and scatters)."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import is_dtensor


def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    """Statistics in f32, normalised values cast back to x's type before
    the affine, as the JAX function does."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt) * scale + bias


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_specs(cfg: ModelConfig, d=None):
    from repro_torch.models.common import spec
    d = d or cfg.d_model
    out = {"scale": spec((d,), ("embed",), init="ones")}
    if cfg.norm == "ln":
        out["bias"] = spec((d,), ("embed",), init="zeros")
    return out


def _rope_angles(positions, rot_dim, theta):
    """positions (..., S) -> cos/sin of shape (..., S, rot_dim//2). The
    inverse frequencies use the JAX package's numpy arithmetic (float64,
    then f32 on the multiply)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, rot_dim, 2) / rot_dim))
    inv = torch.as_tensor(inv_freq.astype(np.float32), device=positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x, cos, sin):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_dim(cfg: ModelConfig, dh: int) -> int:
    """The rotated elements of a head: all of it, or ``int(dh *
    rope_fraction)`` for partial RoPE, rounded down to even."""
    rot = int(dh * cfg.rope_fraction) if cfg.rope_style == "partial" else dh
    return rot - rot % 2


def apply_rope(cfg: ModelConfig, x, positions):
    """x (B, S, H, dh), positions (B, S) int, or (3, B, S) for m-RoPE (2-D
    positions serve all three sections: text-only input). Only the first
    ``rope_dim`` elements of a head rotate; m-RoPE takes each section's
    frequencies from its own position stream."""
    if cfg.rope_style == "none":
        return x
    dt = x.dtype
    rot = rope_dim(cfg, x.shape[-1])
    if cfg.rope_style == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta)  # (3,B,S,r/2)
        secs = cfg.mrope_sections
        if sum(secs) != rot // 2:
            raise ValueError(f"mrope_sections {secs} must sum to {rot // 2}")
        bounds = np.cumsum((0,) + tuple(secs))
        cos = torch.cat([cos[i, ..., bounds[i]:bounds[i + 1]]
                         for i in range(3)], dim=-1)
        sin = torch.cat([sin[i, ..., bounds[i]:bounds[i + 1]]
                         for i in range(3)], dim=-1)
    else:
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta)
    cos, sin = cos[..., None, :], sin[..., None, :]          # (B,S,1,rot/2)
    xr = _rotate_half(x[..., :rot].float(), cos, sin).to(dt)
    if rot == x.shape[-1]:
        return xr
    return torch.cat([xr, x[..., rot:]], dim=-1)


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Oracle quadratic attention. q (B,Sq,Hq,dh), k (B,Sk,Hkv,dh), v
    (B,Sk,Hkv,dv) -> (B,Sq,Hq,dv); scores and softmax in f32 (scale
    1/sqrt(dh)), probabilities cast to v's dtype for the value product (as
    the JAX oracle does)."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, dv)


def attention(q, k, v, *, causal=True, window=0):
    """Prefill / forward attention, q (B,Sq,Hq,dk), k (B,Sk,Hkv,dk), v
    (B,Sk,Hkv,dv) -> (B,Sq,Hq,dv), scale 1/sqrt(dk); Sk != Sq only for a
    call that is neither causal nor windowed (cross-attention): the
    ``flash_prefill`` kernel on the card (dk = dv, or MLA's 192 / 128), its
    plain version (the quadratic oracle) on the CPU. DTensors go through
    ``sharded_attention``."""
    from repro_torch.kernels.flash_attention import ops
    if is_dtensor(q):
        return sharded_attention(q, k, v, causal=causal, window=window)
    return ops.attention(q, k, v, causal=causal, window=window)


_DATA_AXES = ("pod", "data")


def _mesh_placements(mesh, data, model):
    """One placement a mesh dim: ``data`` on the data axes, ``model`` on
    'model', ``Replicate()`` on any other and on an axis of one rank (as
    ``partitioning.placements``)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if size == 1 else data if n in _DATA_AXES
                 else model if n == "model" else Replicate()
                 for n, size in zip(mesh.mesh_dim_names, mesh.shape))


def _data_size(mesh) -> int:
    return int(np.prod([s for n, s in zip(mesh.mesh_dim_names, mesh.shape)
                        if n in _DATA_AXES]))


def _model_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index("model")] if "model" in names else 1


def local_elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; a DTensor's on each rank's
    shard through ``local_map`` (DTensor has no sharding rule for some
    elementwise backward, ``log_sigmoid``'s among them), a partial sum
    reduced first."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_map(fn, out_placements=list(pl), in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def sharded_embedding(table, tokens):
    """``table[tokens]`` of a DTensor table through ``local_map``. A table
    whose vocab shards over 'model' gives each rank the rows it holds
    (tokens outside them read row 0, zeroed), a partial sum over 'model'
    that is reduced here, exactly (one rank adds its row to zeros); the
    tokens keep their placement over the data axes, and the table's
    gradient is a partial sum over them where the tokens shard."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    m_pl = table.placements[names.index("model")] if "model" in names \
        else Replicate()
    vocab = isinstance(m_pl, Shard) and m_pl.dim == 0
    rows = table.shape[0] // _model_size(mesh) if vocab else table.shape[0]
    first = mesh.get_local_rank("model") * rows if vocab else 0
    t_data = next((p for n, p in zip(names, tokens.placements)
                   if n in _DATA_AXES), Replicate()) \
        if is_dtensor(tokens) else Replicate()
    t_pl = _mesh_placements(mesh, t_data, Replicate())
    tab_pl = _mesh_placements(mesh, Replicate(), m_pl)
    grad_pl = _mesh_placements(
        mesh, Partial() if isinstance(t_data, Shard) else Replicate(), m_pl)

    def local(tab, tok):
        if not vocab:
            return tab[tok]
        mine = (tok >= first) & (tok < first + rows)
        return tab[torch.where(mine, tok - first, 0)] \
            * mine[..., None].to(tab.dtype)

    out = local_map(local, out_placements=list(_mesh_placements(
        mesh, t_data, Partial() if vocab else Replicate())),
        in_placements=(tab_pl, t_pl), in_grad_placements=(grad_pl, t_pl),
        device_mesh=mesh, redistribute_inputs=True)(table, tokens)
    return out.redistribute(mesh, t_pl)


def sharded_attention(q, k, v, *, causal=True, window=0):
    """``attention`` of DTensors: each rank's local call (the kernel on the
    card, its plain version on the CPU) through ``local_map``. q shards its
    batch over the data axes and its heads over 'model' (each where the
    axes divide them); k and v shard their kv heads with q's heads where
    'model' divides them, else they replicate and each rank attends with
    the kv heads its q heads read (one kv head and a smaller G, or one a
    q head where the shard straddles kv heads), their gradient a partial
    sum over 'model'."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    B, _, Hq, _ = q.shape
    Hkv = k.shape[2]
    tp = _model_size(mesh)
    data = Shard(0) if B % _data_size(mesh) == 0 else Replicate()
    q_heads = tp > 1 and Hq % tp == 0
    kv_heads = q_heads and Hkv % tp == 0
    qp = _mesh_placements(mesh, data, Shard(2) if q_heads else Replicate())
    kv_model = Shard(2) if kv_heads else Replicate()
    kvp = _mesh_placements(mesh, data, kv_model)
    kvg = _mesh_placements(mesh, data, Partial() if q_heads and not kv_heads
                           else kv_model)
    G = Hq // Hkv
    rank = mesh.get_local_rank("model") if q_heads else 0

    def local(ql, kl, vl):
        from repro_torch.kernels.flash_attention import ops
        if q_heads and not kv_heads:
            kl, vl = _rank_kv_heads(kl, vl, rank * ql.shape[2], ql.shape[2],
                                    G)
        return ops.attention(ql, kl, vl, causal=causal, window=window)

    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kvg, kvg), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _rank_kv_heads(kl, vl, first, hq, G):
    """The kv heads (dim 2) that q heads ``first .. first + hq - 1`` read,
    G q heads a kv head: one kv head where hq divides G, else one a q
    head."""
    if G % hq == 0:
        sl = slice(first // G, first // G + 1)
        return kl[:, :, sl], vl[:, :, sl]
    idx = (first + torch.arange(hq, device=kl.device)) // G
    return kl[:, :, idx], vl[:, :, idx]


def sharded_decode_attention(q, k_cache, v_cache, valid_mask):
    """``decode_attention`` of DTensors through ``local_map``, placed as
    ``sharded_attention`` places attention: q's batch over the data axes
    and its heads over 'model', the caches' kv heads with them where
    'model' divides them, else whole on every rank, which attends with the
    kv heads its q heads read. A plain mask (the same on every rank) is
    sharded with the batch."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    B, _, Hq, _ = q.shape
    Hkv = k_cache.shape[2]
    tp = _model_size(mesh)
    data = Shard(0) if B % _data_size(mesh) == 0 else Replicate()
    q_heads = tp > 1 and Hq % tp == 0
    kv_heads = q_heads and Hkv % tp == 0
    qp = _mesh_placements(mesh, data, Shard(2) if q_heads else Replicate())
    kvp = _mesh_placements(mesh, data, Shard(2) if kv_heads else Replicate())
    vp = _mesh_placements(mesh, data, Replicate())
    if not is_dtensor(valid_mask):
        valid_mask = distribute_tensor(valid_mask, mesh, vp,
                                       src_data_rank=None)
    G = Hq // Hkv
    rank = mesh.get_local_rank("model") if q_heads else 0

    def local(ql, kl, vl, ml):
        if q_heads and not kv_heads:
            kl, vl = _rank_kv_heads(kl, vl, rank * ql.shape[2], ql.shape[2],
                                    G)
        return decode_attention(ql, kl, vl, ml)

    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp, vp), device_mesh=mesh,
                     redistribute_inputs=True)(q, k_cache, v_cache,
                                               valid_mask)


def decode_attention(q, k_cache, v_cache, valid_mask):
    """Single-token decode. q (B,1,Hq,dh); caches (B,S,Hkv,dh); valid_mask
    (B,S) bool. Scores and softmax in f32; probabilities cast to the cache's
    dtype for the value product, summed in f32 (as the JAX function does).
    DTensors go through ``sharded_decode_attention``."""
    if is_dtensor(q):
        return sharded_decode_attention(q, k_cache, v_cache, valid_mask)
    B, _, Hq, dh = q.shape
    _, S, Hkv, dv = v_cache.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) \
        / math.sqrt(dh)
    s = s.masked_fill(~valid_mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, dv).to(q.dtype)


def _gated(cfg: ModelConfig) -> bool:
    return cfg.act in ("swiglu", "geglu")


def ffn_specs(cfg: ModelConfig, d_ff=None):
    from repro_torch.models.common import spec
    D, F = cfg.d_model, d_ff or cfg.d_ff
    if _gated(cfg):
        p = {"wi_gate": spec((D, F), ("embed", "ffn")),
             "wi_up": spec((D, F), ("embed", "ffn"))}
    else:
        p = {"wi": spec((D, F), ("embed", "ffn"))}
    p["wo"] = spec((F, D), ("ffn", "embed"))
    if cfg.mlp_bias:
        for k in (("bi_gate", "bi_up") if _gated(cfg) else ("bi",)):
            p[k] = spec((F,), ("ffn",), init="zeros")
        p["bo"] = spec((D,), ("embed",), init="zeros")
    return p


def act(cfg: ModelConfig, x):
    """SiLU for SwiGLU; GELU's tanh form (JAX's ``approximate=True``) for
    GeGLU and the plain GELU MLP."""
    if cfg.act == "swiglu":
        return torch.nn.functional.silu(x)
    return torch.nn.functional.gelu(x, approximate="tanh")


def ffn_hidden(cfg: ModelConfig, p, x):
    """The FFN's hidden activation before the down projection: act(gate) *
    up, or act(x @ wi) for the non-gated MLP, with the input biases."""
    bias = cfg.mlp_bias
    if _gated(cfg):
        g = x @ p["wi_gate"]
        u = x @ p["wi_up"]
        if bias:
            g, u = g + p["bi_gate"], u + p["bi_up"]
        return act(cfg, g) * u
    h = x @ p["wi"]
    return act(cfg, h + p["bi"] if bias else h)


def ffn_apply(cfg: ModelConfig, p, x):
    y = ffn_hidden(cfg, p, x) @ p["wo"]
    return y + p["bo"] if cfg.mlp_bias else y


# ----------------------------------------------------------------------
# MoE (sort-based dispatch, as the JAX package's ``moe_apply``)
# ----------------------------------------------------------------------

def moe_specs(cfg: ModelConfig):
    """An f32 router ``(D, E)``, the experts' SwiGLU weights stacked on a
    leading expert axis (fan-in the D or F axis), and, with
    ``n_shared_experts``, one shared FFN of ``moe_d_ff * n_shared`` hidden
    units."""
    from repro_torch.models.common import spec
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": spec((D, E), ("embed", "experts_r"), dtype=torch.float32),
        "experts": {
            "wi_gate": spec((E, D, F), ("experts", "embed", "expert_ffn"),
                            fan_in_axes=(1,)),
            "wi_up": spec((E, D, F), ("experts", "embed", "expert_ffn"),
                          fan_in_axes=(1,)),
            "wo": spec((E, F, D), ("experts", "expert_ffn", "embed"),
                       fan_in_axes=(1,)),
        },
    }
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {"wi_gate": spec((D, Fs), ("embed", "ffn")),
                       "wi_up": spec((D, Fs), ("embed", "ffn")),
                       "wo": spec((Fs, D), ("ffn", "embed"))}
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert holds for ``n_tokens`` tokens: JAX's ``max(1,
    ceil(T * K / E * capacity_factor))`` (the same float expression; the
    factor ``ctx.perf().capacity_factor`` where that is set), at most T: an
    expert takes a token at most once, so slots past T stay empty and are
    never read back (the output is the same)."""
    from repro_torch.distributed import ctx
    E, K = cfg.n_experts, cfg.top_k
    cap = ctx.perf().capacity_factor or cfg.capacity_factor
    C = max(1, int(math.ceil(n_tokens * K / E * cap)))
    return min(C, n_tokens)


def moe_route(cfg: ModelConfig, router, xt):
    """xt (T, D) -> (router logits (T, E) f32, combine weights (T, K) f32,
    experts (T, K)): softmax over the f32 logits, top-k, renormalised over
    the top-k for Mixtral (``family == "moe"``), times ``routed_scale``."""
    logits = xt.float() @ router
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, cfg.top_k, dim=-1)
    if cfg.family == "moe":
        topw = topw / topw.sum(-1, keepdim=True)
    return logits, topw * cfg.routed_scale, topi


def moe_dispatch(cfg: ModelConfig, topi, first: int = 0, n_local=None):
    """The (token, choice) assignments of ``topi`` (T, K), flattened token
    by token and sorted stably by expert: (order, each one's expert, its
    rank within the expert). An assignment whose rank reaches
    ``moe_capacity(cfg, T)`` is dropped. With ``n_local`` < E only the
    experts ``first .. first + n_local - 1`` are this rank's: they are
    numbered from 0, and every other assignment gets ``n_local`` and sorts
    last (JAX's ``moe_apply_ep_local``); a local expert's ranks are its
    ranks among all experts."""
    E = cfg.n_experts
    n_local = E if n_local is None else n_local
    eid = topi.reshape(-1)
    if n_local < E:
        mine = (eid >= first) & (eid < first + n_local)
        eid = torch.where(mine, eid - first, torch.full_like(eid, n_local))
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    # per-expert counts by a scatter (bincount would read its maximum back
    # to the host on the card)
    counts = torch.zeros(n_local + (n_local < E), dtype=eid_s.dtype,
                         device=eid.device).scatter_add_(
        0, eid_s, torch.ones_like(eid_s))
    starts = torch.cumsum(counts, 0) - counts
    return order, eid_s, torch.arange(len(eid), device=eid.device) \
        - starts[eid_s]


def moe_slots(cfg: ModelConfig, topi, C: int, n_local: int,
              first: int = 0):
    """Where each (token, choice) assignment of ``topi`` (T, K) goes, in
    expert order (``moe_dispatch``): (its index in ``topi``'s (T * K), its
    token, its expert's row among the ``n_local`` from ``first``, its
    slot, kept). Past ``C`` slots, or to an expert not among the local
    ones, an assignment is dropped: slot C, zeroed."""
    order, eid_s, pos = moe_dispatch(cfg, topi, first, n_local)
    keep = (eid_s < n_local) & (pos < C)
    return (order, order // cfg.top_k,
            torch.where(keep, eid_s, torch.zeros_like(eid_s)),
            torch.where(keep, pos, torch.full_like(pos, C)), keep)


def moe_scatter(xt, slots, C: int, n_local: int):
    """The dispatch buffer (n_local, C, D) of tokens xt (T, D): each kept
    assignment's token row in its expert's slot, the rest zero."""
    _, tid_s, row, pos_c, keep = slots
    xe = xt.new_zeros((n_local, C + 1, xt.shape[1]))
    xe[row, pos_c] = torch.where(keep[:, None], xt[tid_s],
                                 torch.zeros((), dtype=xt.dtype,
                                             device=xt.device))
    return xe[:, :C]


def moe_combine(ye, topw, slots, C: int):
    """The experts' output (T, D) f32 from the result buffer ye (n_local,
    C, D): each kept assignment's row, cast with its combine weight
    (``topw`` (T, K)) to ye's type and multiplied, summed per token in
    f32."""
    order, tid_s, row, pos_c, keep = slots
    w_s = topw.reshape(-1)[order]
    yc = ye[row, torch.clamp(pos_c, max=C - 1)]
    yc = yc * (w_s * keep.to(w_s.dtype))[:, None].to(yc.dtype)
    out = torch.zeros((topw.shape[0], ye.shape[-1]), dtype=torch.float32,
                      device=ye.device)
    out.index_add_(0, tid_s, yc.float())
    return out


def moe_experts(cfg: ModelConfig, experts, xt, topw, topi, C: int,
                first: int = 0):
    """The routed experts' output (T, D) f32 for tokens xt (T, D) routed to
    ``topi`` with weights ``topw`` (T, K), at ``C`` slots an expert. The
    (token, choice) assignments, sorted stably by expert, take the
    expert's slots in that order; past C an assignment is dropped
    (``moe_slots``). Each expert's SwiGLU runs on its (C, D) slots
    (``moe_scatter``); the outputs are combined per token
    (``moe_combine``). ``experts`` may hold a run of E_loc experts from
    ``first`` (expert parallelism: the others' assignments are dropped
    here), or every expert's shard of the hidden dim."""
    n_local = experts["wo"].shape[0]
    slots = moe_slots(cfg, topi, C, n_local, first)
    xe = moe_scatter(xt, slots, C, n_local)
    ye = ffn_hidden(cfg, experts, xe) @ experts["wo"]      # (E_loc,C,D)
    return moe_combine(ye, topw, slots, C)


def moe_apply(cfg: ModelConfig, p, x):
    """x (B, S, D) -> (B, S, D): ``moe_experts`` over all B * S tokens
    (``moe_capacity`` of them), cast to x's type; a shared expert's FFN is
    added after the cast, as JAX's does. DTensors go through
    ``sharded_moe``."""
    if is_dtensor(x):
        return sharded_moe(cfg, p, x)
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    _, topw, topi = moe_route(cfg, p["router"], xt)
    out = moe_experts(cfg, p["experts"], xt, topw, topi,
                      moe_capacity(cfg, T)).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + ffn_apply(cfg, p["shared"], xt)
    return out.reshape(B, S, D)


def sharded_moe(cfg: ModelConfig, p, x):
    """``moe_apply`` of DTensors, its routing and dispatch on each rank
    through ``local_map``; the experts keep their params' placement over
    'model' (a run of E / tp experts a rank, or, where tp does not divide
    E, a shard of each expert's hidden dim), and each rank's f32 output is
    a partial sum over 'model', reduced before the cast.

    ``ctx.perf().moe_ep_local`` off (JAX's default): the tokens are
    gathered over the data axes, and every rank routes and dispatches all
    B * S of them as the single-device ``moe_apply`` does, at its capacity
    and with its drops (GSPMD keeps the global meaning). On, with E
    divisible by the 'model' axis: JAX's ``moe_apply_ep_local``, each data
    shard's tokens routed locally at the capacity of the local tokens, one
    reduction over 'model' the only collective. Off, and under a named
    ``moe_dispatch`` placement: ``pinned_moe``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed import ctx
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    B, S, _ = x.shape
    E, tp = cfg.n_experts, _model_size(mesh)
    ex = [p["experts"][k] for k in ("wi_gate", "wi_up", "wo")]
    # each expert weight's placement over 'model' (E, or its hidden dim)
    m_pls = [w.placements[names.index("model")] if "model" in names
             else Replicate() for w in ex]
    m_pl = m_pls[-1]
    ep = isinstance(m_pl, Shard) and m_pl.dim == 0
    sharded = not isinstance(m_pl, Replicate)
    local_tokens = ctx.perf().moe_ep_local and ep and E % tp == 0
    if local_tokens and B % _data_size(mesh):
        raise ValueError(f"moe_ep_local: batch {B} does not divide over the "
                         f"data axes ({_data_size(mesh)})")
    first = mesh.get_local_rank("model") * (E // tp) if ep else 0
    if ctx.named("moe_dispatch") is not None and not local_tokens:
        if not (ep and E % tp == 0):
            raise ValueError(
                f"moe_dispatch: pins the (E, C, D) buffers by expert over "
                f"'model'; the experts of {cfg.name} ({E} over {tp}) do not "
                "shard by expert")
        return pinned_moe(cfg, p, x, first)
    part = Partial() if sharded else Replicate()
    d_tok = Shard(0) if local_tokens else Replicate()
    # gradients: a local input's share of the sum over 'model' where the
    # experts shard; over the data axes, the local tokens' share where each
    # rank routes its own
    d_grad = Partial() if local_tokens else Replicate()
    in_pl = (_mesh_placements(mesh, d_tok, Replicate()),
             _mesh_placements(mesh, Replicate(), Replicate()),
             *(_mesh_placements(mesh, Replicate(), m) for m in m_pls))
    grad_pl = (_mesh_placements(mesh, d_tok, part),
               _mesh_placements(mesh, d_grad, part),
               *(_mesh_placements(mesh, d_grad, m) for m in m_pls))

    def local(xl, router, wg, wu, wo):
        Bl, Sl, D = xl.shape
        xt = xl.reshape(Bl * Sl, D)
        _, topw, topi = moe_route(cfg, router, xt)
        out = moe_experts(cfg, {"wi_gate": wg, "wi_up": wu, "wo": wo}, xt,
                          topw, topi, moe_capacity(cfg, Bl * Sl), first)
        return out.reshape(Bl, Sl, D)

    out = local_map(local,
                    out_placements=list(_mesh_placements(mesh, d_tok, part)),
                    in_placements=in_pl, in_grad_placements=grad_pl,
                    device_mesh=mesh, redistribute_inputs=True)(
        x, p["router"], *ex)
    out = out.redistribute(mesh, x.placements).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + ffn_apply(cfg, p["shared"], x)
    return out


def pinned_moe(cfg: ModelConfig, p, x, first: int):
    """``sharded_moe`` with the (E, C, D) dispatch and result buffers
    DTensors placed by the named ``moe_dispatch`` spec (JAX's
    ``PerfOptions.moe_dispatch_constraint``, which ``launch/dryrun.py``
    sets as JAX's ``_lower_for`` does: ``('model', None, None)``, by
    expert over 'model'), the experts sharded by expert, from ``first``
    on each rank. Each rank routes its own tokens; the routing
    is gathered, and every rank dispatches all B * S tokens (gathered) into
    its experts' slots, at the single-device capacity and drops; the FFN
    runs on those slots. The combine takes the result buffer whole on
    every rank (its ``in_placements`` gather it over 'model') and combines
    every token, its output whole, then laid out as x is. The output is
    the single-device ``moe_apply``'s. These gathers of x, the routing and
    the result buffer cost more bytes than the unpinned path's one
    reduction; an all-to-all of the buffers, as GSPMD makes of JAX's pins,
    is not written yet (ROADMAP.md)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed import ctx
    mesh = x.device_mesh
    B, S, D = x.shape
    E, tp = cfg.n_experts, _model_size(mesh)
    C = moe_capacity(cfg, B * S)
    rep = _mesh_placements(mesh, Replicate(), Replicate())
    by_expert = _mesh_placements(mesh, Replicate(), Shard(0))
    # a shard of the tokens routes its own: the router's gradient is a
    # partial sum over the mesh dims that shard them
    router_grad = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                        for pl in x.placements)

    def route(xl, router):
        Bl, Sl, _ = xl.shape
        _, topw, topi = moe_route(cfg, router, xl.reshape(Bl * Sl, D))
        return topw.reshape(Bl, Sl, -1), topi.reshape(Bl, Sl, -1)

    topw, topi = local_map(
        route, out_placements=(list(x.placements), list(x.placements)),
        in_placements=(x.placements, rep),
        in_grad_placements=(x.placements, router_grad), device_mesh=mesh)(
        x, p["router"])
    topw = topw.redistribute(mesh, rep).to_local().reshape(B * S, -1)
    topi = topi.redistribute(mesh, rep).to_local().reshape(B * S, -1)
    slots = moe_slots(cfg, topi, C, E // tp, first)

    def dispatch(xl):
        return moe_scatter(xl.reshape(B * S, D), slots, C, E // tp)

    xe = local_map(dispatch, out_placements=list(by_expert),
                   in_placements=(rep,),
                   in_grad_placements=(_mesh_placements(
                       mesh, Replicate(), Partial()),),
                   device_mesh=mesh, redistribute_inputs=True)(x)
    xe = ctx.constrain_named("moe_dispatch", xe)
    ye = ffn_hidden(cfg, p["experts"], xe) @ p["experts"]["wo"]
    ye = ctx.constrain_named("moe_dispatch", ye)
    everywhere = moe_slots(cfg, topi, C, E)

    def combine(ye_all, w):
        return moe_combine(ye_all, w, everywhere, C).reshape(B, S, D)

    out = local_map(combine, out_placements=list(rep),
                    in_placements=(rep, None),
                    in_grad_placements=(rep, None), device_mesh=mesh,
                    redistribute_inputs=True)(ye, topw)
    out = out.redistribute(mesh, x.placements).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + ffn_apply(cfg, p["shared"], x)
    return out
