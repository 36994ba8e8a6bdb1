"""xLSTM family (counterpart of ``repro.models.xlstm``): mLSTM blocks
(chunkwise-parallel) and sLSTM blocks (sequential).

48 blocks = 6 groups of (7 mLSTM + 1 sLSTM) for xlstm-1.3b
(``slstm_every`` 8), the groups stacked on a leading G axis and the mLSTM
blocks of a group on a second one, iterated with Python loops. The mLSTM
matrix-memory recurrence is computed chunkwise over chunks of
``min(256, S)`` positions (S must be a multiple of it): quadratic with
decay weights inside a chunk, the carried (C, n) state across chunks; a
decode step is the single-step recurrence. Input-gate logits are clipped
to [-10, 10] instead of carrying the max-stabiliser through the chunkwise
path; forget gates are log-sigmoids, so no exponent of a kept term
overflows. The sLSTM keeps the exact max-stabiliser.

Numerics follow JAX's: by default (``PerfOptions.mlstm_bf16`` off) the
chunkwise mLSTM computes in f32; with the field on, in bf16 where JAX's
does, with f32 gates, state and sums (``mlstm_chunkwise``). JAX's
rounding points are kept where its code has them: the gate logits are a
product plus a bias in the weights' type, cast to f32 after the add; a
step's ``k ⊗ v`` and ``q / sqrt(dh)`` stay in the inputs' type; the
sLSTM's ``x_t W + h R + b`` is summed in the weights' type with ``h``
rounded to bf16; the per-head
RMS norm casts to bf16; the sLSTM's output is cast to the input's type
before the residual. Where JAX's einsum promotes a bf16 operand against
an f32 one, the port casts it up first (``_ein``).

No Pallas kernel computes either recurrence in JAX (both are XLA), so
both stay plain PyTorch here.

On a mesh (DTensors, the mesh builders of ``distributed.stepfn``) both
blocks take the whole sequence: with Megatron-SP ``transformer._normed``
gathers each normed input and ``transformer._residual`` places each
output as the residual is, as around attention and the MLP. The sLSTM's
step loop runs each rank's batch shard through ``local_map``
(``_slstm_scan``): its weights replicate over 'model', so every rank of a
model group steps the same rows, and no step's op goes through DTensor.
The mLSTM's core runs so too (``_mlstm_core``), each head whole: its
projections shard over 'model' as JAX's do, and their outputs are
gathered for it.

The state keeps JAX's layout: ``{"mlstm": {"C" (G,n_m,B,H,dh,dh) f32,
"n" (G,n_m,B,H,dh) f32, "conv" (G,n_m,B,cw-1,Di)}, "slstm": {"h", "c",
"n", "m"} (G,B,D) f32}``; its size does not depend on the sequence.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import remat_call, spec, unstack
from repro_torch.models.rglru import _take, causal_conv
from repro_torch.models.transformer import _stack

_CHUNK = 256
_ILOG_CLIP = 10.0


def _dims(cfg: ModelConfig):
    D = cfg.d_model
    Di = int(cfg.mlstm_proj_factor * D)
    H = cfg.n_heads
    dh = Di // H
    Fs = ((4 * D // 3) // 128) * 128      # sLSTM post-FFN hidden
    return D, Di, H, dh, Fs


def _ein(eq, *xs):
    """``torch.einsum`` with JAX's type promotion: every operand cast to
    their common type first."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *(x.to(dt) for x in xs))


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

def _mlstm_specs(cfg: ModelConfig):
    D, Di, H, dh, _ = _dims(cfg)
    cw = cfg.conv_width
    return {
        "norm": L.norm_specs(cfg),
        "w_up": spec((D, Di), ("embed", "mlstm_v")),
        "w_z": spec((D, Di), ("embed", "mlstm_v")),
        "conv_w": spec((cw, Di), ("conv", "mlstm_v"), fan_in_axes=(0,)),
        "conv_b": spec((Di,), ("mlstm_v",), init="zeros"),
        "wq": spec((H, dh, dh), ("heads", "head_in", "mlstm_vh"),
                   fan_in_axes=(1,)),
        "wk": spec((H, dh, dh), ("heads", "head_in", "mlstm_vh"),
                   fan_in_axes=(1,)),
        "wv": spec((H, dh, dh), ("heads", "head_in", "mlstm_vh"),
                   fan_in_axes=(1,)),
        "w_i": spec((Di, H), ("mlstm_v", "heads")),
        "b_i": spec((H,), ("heads",), init="zeros"),
        "w_f": spec((Di, H), ("mlstm_v", "heads")),
        "b_f": spec((H,), ("heads",), init="ones"),
        "gn": spec((Di,), ("mlstm_v",), init="ones"),
        "w_down": spec((Di, D), ("mlstm_v", "embed")),
    }


def _slstm_specs(cfg: ModelConfig):
    D, _, _, _, Fs = _dims(cfg)
    H = cfg.slstm_heads
    dh = D // H
    gates = {}
    for g in ("z", "i", "f", "o"):
        gates[f"w_{g}"] = spec((D, D), ("embed", "slstm_d"))
        gates[f"r_{g}"] = spec((H, dh, dh), ("heads", "head_in", "slstm_dh"),
                               fan_in_axes=(1,))
        gates[f"b_{g}"] = spec((D,), ("slstm_d",), init="zeros")
    return {
        "norm": L.norm_specs(cfg),
        **gates,
        "ffn_norm": L.norm_specs(cfg),
        "w_up": spec((D, Fs), ("embed", "ffn")),
        "w_dn": spec((Fs, D), ("ffn", "embed")),
    }


def _group_counts(cfg: ModelConfig):
    """(groups, mLSTM blocks a group)."""
    per = cfg.slstm_every
    if cfg.family != "xlstm" or per < 1 or cfg.n_layers % per:
        raise ValueError(f"{cfg.name!r}: an xlstm config's n_layers "
                         f"({cfg.n_layers}) must divide into groups of "
                         f"slstm_every ({per}) blocks")
    return cfg.n_layers // per, per - 1


def param_specs(cfg: ModelConfig):
    G, n_m = _group_counts(cfg)
    group = {"mlstm": _stack(_mlstm_specs(cfg), n_m),
             "slstm": _slstm_specs(cfg)}
    return {
        "embed": {"tok": spec((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), fan_in_axes=())},
        "groups": _stack(group, G),
        "final_norm": L.norm_specs(cfg),
        "lm_head": spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


# ----------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------

def _mh_rms(x, scale):
    """Per-head RMS norm in f32: x (B,S,H,dh), scale (H*dh,); then the
    scale, then bf16."""
    B, S, H, dh = x.shape
    y = L.rms_norm(x.float(), torch.ones((dh,), dtype=torch.float32,
                                         device=x.device))
    return (y.reshape(B, S, H * dh) * scale).to(torch.bfloat16)


def mlstm_chunkwise(q, k, v, ilog, flog, state=None, chunk=_CHUNK):
    """q, k, v (B,S,H,dh); ilog / flog (B,S,H) f32 (flog <= 0). state:
    {'C': (B,H,dh,dh) f32, 'n': (B,H,dh) f32} or None (zeros). S must be a
    multiple of ``min(chunk, S)``. Returns (h (B,S,H,dh) f32, new state).

    Computes in f32, or, under ``PerfOptions.mlstm_bf16``, at JAX's bf16
    rounding points: q·scale (the scale rounded to bf16 first), k and v
    rounded to bf16; the intra-chunk scores and the state's products take
    the rounded values, each product exact in f32 and summed in f32 (JAX's
    ``preferred_element_type``); ``s`` is rounded before it meets v, the
    decay before it meets k, ``wj`` before the state's products. The gates
    and the (C, n) state stay f32. JAX's three-operand state update
    (``bjh,bjhd,bjhe->bhde``) contracts ``wj`` with k first, at f32 (the
    XLA it lowers to: wj·k, then that with v), as here."""
    B, S, H, dh = q.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"mlstm_chunkwise: S = {S} must be a multiple of "
                         f"min({chunk}, S) = {c} (the chunk length)")
    nc = S // c
    scale = 1.0 / math.sqrt(dh)
    if ctx.perf().mlstm_bf16:
        # q, k, v stay bf16 and are upcast at each use, so that each use's
        # gradient is rounded to bf16 on its own and the uses' gradients
        # are summed in bf16, as JAX's cotangents of its bf16 operands are
        bf = torch.bfloat16
        qf = (q.to(bf) * torch.tensor(scale, dtype=bf, device=q.device)) \
            .reshape(B, nc, c, H, dh)
        kf = k.to(bf).reshape(B, nc, c, H, dh)
        vf = v.to(bf).reshape(B, nc, c, H, dh)

        def rnd(t):
            return t.to(bf).float()
    else:
        qf = (q.float() * scale).reshape(B, nc, c, H, dh)
        kf = k.float().reshape(B, nc, c, H, dh)
        vf = v.float().reshape(B, nc, c, H, dh)

        def rnd(t):
            return t
    il = ilog.reshape(B, nc, c, H)
    fl = flog.reshape(B, nc, c, H)
    dev = q.device
    if state is None:
        C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    else:
        C, n = state["C"], state["n"]
    tri = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    hs = []
    for ci in range(nc):
        qc, kc, vc, ic, fc = qf[:, ci], kf[:, ci], vf[:, ci], il[:, ci], \
            fl[:, ci]
        cum = torch.cumsum(fc, dim=1)                   # inclusive log f
        # inter-chunk: h_t += exp(cum_t) q_t C, n_t += exp(cum_t) n
        dec_t = torch.exp(cum)                          # (B,c,H)
        h_inter = torch.einsum("bthd,bhde->bthe", qc.float(), C) \
            * dec_t[..., None]
        n_inter = n[:, None] * dec_t[..., None]
        # intra-chunk decay w_tj = exp(cum_t - cum_j + il_j), j <= t: above
        # the diagonal the exponent may overflow, so the mask selects the
        # exponent (-inf there): the same values as masking the exp, and
        # no inf there for the backward to multiply by a zero gradient
        g = ic - cum                                    # (B,c,H)
        wmat = torch.exp(torch.where(tri[None, :, :, None],
                                     cum[:, :, None] + g[:, None, :],
                                     float("-inf")))
        s = torch.einsum("bthd,bjhd->btjh", qc.float(), kc.float()) \
            * wmat
        h_intra = torch.einsum("btjh,bjhd->bthd", rnd(s), vc.float())
        n_intra = torch.einsum("btjh,bjhd->bthd", rnd(wmat), kc.float())
        den = torch.einsum("bthd,bthd->bth", qc.float(),
                           n_inter + n_intra).abs()
        hs.append((h_inter + h_intra) / torch.clamp_min(den, 1.0)[..., None])
        # the state past the chunk
        last = cum[:, -1]                               # (B,H)
        wj = torch.exp(last[:, None] + g)               # (B,c,H)
        C = C * torch.exp(last)[..., None, None] + torch.einsum(
            "bjhd,bjhe->bhde", kc.float() * rnd(wj)[..., None], vc.float())
        n = n * torch.exp(last)[..., None] + torch.einsum(
            "bjh,bjhd->bhd", rnd(wj), kc.float())
    h = torch.stack(hs, dim=1).reshape(B, S, H, dh)
    return h, {"C": C, "n": n}


def mlstm_step(q, k, v, ilog, flog, state):
    """One decode step. q, k, v (B,H,dh); gates (B,H) f32. ``k ⊗ v`` and
    ``q / sqrt(dh)`` stay in the inputs' type; the state is f32."""
    f = torch.exp(flog)[..., None]
    i = torch.exp(ilog)[..., None]
    C = state["C"] * f[..., None] + i[..., None] * (k[..., :, None]
                                                    * v[..., None, :])
    n = state["n"] * f + i * k
    dh = q.shape[-1]
    # JAX takes the Python scale as a weak type: rounded to q's type first
    qs = q * torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype, device=q.device)
    h = _ein("bhd,bhde->bhe", qs, C)
    den = _ein("bhd,bhd->bh", qs, n).abs()
    h = h / torch.clamp_min(den, 1.0)[..., None]
    return h, {"C": C, "n": n}


def _split_heads(x, H, dh):
    """x (B,S,H*dh) as (B,S,H,dh). A DTensor sharded over its last dim on a
    mesh axis that does not divide H is made whole along it first: DTensor
    cannot split a shard that straddles heads (xlstm-1.3b's 4 heads on a
    16-wide model axis)."""
    if ctx.is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        pl = [Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1
              and H % n else p
              for p, n in zip(x.placements, x.device_mesh.shape)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], H, dh)


def _mlstm_steps(q, k, v, ilog, flog, gn, C=None, n=None):
    """The mLSTM recurrence over q, k, v (B,S,H,dh): chunkwise over a
    sequence (from (C, n) where given), the step recurrence for one token
    after a state; then the per-head norm with scale ``gn``. Returns (the
    normed h (B,S,H*dh) bf16, C, n)."""
    st = None if C is None else {"C": C, "n": n}
    if st is None or q.shape[1] > 1:
        h, st = mlstm_chunkwise(q, k, v, ilog, flog, st)
    else:
        h, st = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ilog[:, 0],
                           flog[:, 0], st)
        h = h[:, None]
    return _mh_rms(h, gn), st["C"], st["n"]


def _mlstm_core(q, k, v, ilog, flog, gn, state):
    """``_mlstm_steps`` on plain tensors, or, for DTensors, on each rank's
    batch shard through ``local_map``, every head whole on every rank of
    a model group (a head's q . k and its state's products span its whole
    width, and xlstm-1.3b's 4 heads do not divide over a 16-wide model
    axis): q, k, v, gn and the state are gathered over 'model' first."""
    args = (q, k, v, ilog, flog, gn) + ((None, None) if state is None
                                        else tuple(state))
    if not ctx.is_dtensor(q):
        return _mlstm_steps(*args)
    from torch.distributed.tensor.experimental import local_map
    rows, whole, w_grad = _row_placements(q)
    st_pl = (None, None) if state is None else (rows, rows)
    return local_map(_mlstm_steps, out_placements=(rows,) * 3,
                     in_placements=(rows,) * 5 + (whole,) + st_pl,
                     in_grad_placements=(rows,) * 5 + (w_grad,) + st_pl,
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(*args)


def _row_placements(x):
    """For a recurrence run on each rank's rows of DTensor ``x`` (B, ...):
    the rows' placements (the batch over the data axes where they divide
    it, whole over 'model'), a weight's (whole), and the weight's gradient
    (each rank's share of the sum over its batch shard)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    sharded = x.shape[0] % L._data_size(mesh) == 0
    return (L._mesh_placements(mesh, Shard(0) if sharded else Replicate(),
                               Replicate()),
            L._mesh_placements(mesh, Replicate(), Replicate()),
            L._mesh_placements(mesh, Partial() if sharded else Replicate(),
                               Replicate()))


def mlstm_block(cfg: ModelConfig, p, x, state=None):
    """x (B,S,D); state {'C','n','conv'} or None. Returns (y, new state):
    chunkwise over a sequence (from the state where one is given), the
    step recurrence for one token after a state."""
    B, S, D = x.shape
    _, Di, H, dh, _ = _dims(cfg)
    h = T._normed(cfg, p["norm"], x)
    u = h @ p["w_up"]                                   # (B,S,Di)
    z = h @ p["w_z"]
    conv_state = state["conv"] if state is not None else None
    cpre, new_conv = causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    cact = F.silu(cpre)
    ch = _split_heads(cact, H, dh)
    uh = _split_heads(u, H, dh)
    q = _ein("bshd,hde->bshe", ch, p["wq"])
    k = _ein("bshd,hde->bshe", ch, p["wk"])
    v = _ein("bshd,hde->bshe", uh, p["wv"])
    ilog = torch.clamp((cact @ p["w_i"] + p["b_i"]).float(), -_ILOG_CLIP,
                       _ILOG_CLIP)
    flog = L.local_elementwise(F.logsigmoid,
                               (cact @ p["w_f"] + p["b_f"]).float())
    st = None if state is None else (state["C"], state["n"])
    hn, C, n = _mlstm_core(q, k, v, ilog, flog, p["gn"], st)   # (B,S,Di)
    new_st = {"C": C, "n": n}
    out = (hn * F.silu(z)) @ p["w_down"]
    return T._residual(x, out), {"C": new_st["C"], "n": new_st["n"],
                                 "conv": new_conv}


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------

def _gate_weights(p):
    """The four gates' input weights side by side (D, 4D), recurrent
    weights (H, dh, 4 dh) and biases (4, D), in z, i, f, o order."""
    H, dh, _ = p["r_z"].shape
    gs = ("z", "i", "f", "o")
    w = torch.stack([p[f"w_{g}"] for g in gs], dim=1)        # (D,4,D)
    r = torch.stack([p[f"r_{g}"] for g in gs], dim=2)        # (H,dh,4,dh)
    b = torch.stack([p[f"b_{g}"] for g in gs])               # (4,D)
    return w.reshape(w.shape[0], -1), r.reshape(H, dh, 4 * dh), b


def _slstm_rec(r, b, h_prev, xw_t):
    """The four gates' pre-activations (B,4,D) f32 of one step, from
    ``_gate_weights``' r and b: ``xw_t`` (B,4,D) is the input's product
    with the gates' weights, h_prev (B,D) is rounded to bf16 for the
    recurrent product; the sum ``x W + h R + b`` is taken in the weights'
    type, then cast to f32."""
    H, dh, _ = r.shape
    B, D = h_prev.shape
    hh = h_prev.reshape(B, H, dh).to(torch.bfloat16)
    rec = _ein("bhd,hde->bhe", hh, r)                   # (B,H,4dh)
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4, D)
    return (xw_t + rec + b).float()


def _slstm_steps(r, b, xw, h, c, n, m):
    """The sLSTM recurrence over xw (B,S,4,D) from the state (h, c, n, m)
    (B,D) f32, or from zeros (n = 1e-6) where h is None. Returns (the
    outputs (B,S,D) f32, h, c, n, m)."""
    B, S, _, D = xw.shape
    if h is None:
        h = torch.zeros((B, D), dtype=torch.float32, device=xw.device)
        c, n, m = h, h + 1e-6, h
    hs = []
    for t in range(S):
        o = _slstm_rec(r, b, h, xw[:, t])
        zt = torch.tanh(o[:, 0])
        logi = torch.clamp(o[:, 1], -_ILOG_CLIP, _ILOG_CLIP)
        logf = F.logsigmoid(o[:, 2])
        m_new = torch.maximum(logf + m, logi)
        i_s = torch.exp(logi - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        h = torch.sigmoid(o[:, 3]) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), h, c, n, m


def _slstm_scan(r, b, xw, state):
    """``_slstm_steps`` on plain tensors, or, for DTensors, on each rank's
    shard through ``local_map``: the batch over the data axes where they
    divide it, r and b replicated (their gradient a partial sum over the
    data axes where the batch shards)."""
    args = (r, b, xw) + ((None,) * 4 if state is None else
                         tuple(state[k] for k in ("h", "c", "n", "m")))
    if not ctx.is_dtensor(xw):
        return _slstm_steps(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh = xw.device_mesh
    rows, whole, w_grad = _row_placements(xw)
    st_pl = (None,) * 4 if state is None else (rows,) * 4
    return local_map(_slstm_steps, out_placements=(rows,) * 5,
                     in_placements=(whole, whole, rows, *st_pl),
                     in_grad_placements=(w_grad, w_grad, rows, *st_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def slstm_apply(cfg: ModelConfig, p, x, state=None):
    """Sequential sLSTM with the exact max-stabiliser, then its GELU
    post-FFN. x (B,S,D); state {'h','c','n','m'} (B,D) f32 or None
    (zeros, n = 1e-6). The input's products with the gate weights are
    taken for all S at once (the same rounding a step's would have), the
    recurrence one position at a time. Returns (y, new state)."""
    B, S, D = x.shape
    xn = T._normed(cfg, p["norm"], x)
    w, r, b = _gate_weights(p)
    xw = (xn @ w).reshape(B, S, 4, D)
    hs, h, c, n, m = _slstm_scan(r, b, xw, state)
    out = T._residual(x, hs.to(x.dtype))
    hn = T._normed(cfg, p["ffn_norm"], out)
    out = T._residual(out, F.gelu(hn @ p["w_up"], approximate="tanh")
                      @ p["w_dn"])
    return out, {"h": h, "c": c, "n": n, "m": m}


# ----------------------------------------------------------------------
# model API
# ----------------------------------------------------------------------

def _stack_trees(trees):
    """The leaves of same-shaped trees stacked on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _group_apply(cfg: ModelConfig, gp, x, states=None):
    """One group: its mLSTM blocks, then its sLSTM. ``states`` the group's
    slice of the state tree, or None. Returns (x, the group's new
    states)."""
    new_m = []
    for i, mp in enumerate(unstack(gp["mlstm"])):
        st = None if states is None else _take(states["mlstm"], i)
        x, ns = mlstm_block(cfg, mp, x, st)
        new_m.append(ns)
    s_st = None if states is None else states["slstm"]
    x, s_new = slstm_apply(cfg, gp["slstm"], x, s_st)
    return x, {"mlstm": _stack_trees(new_m), "slstm": s_new}


def forward(cfg: ModelConfig, params, batch, *, remat=False, last_only=False,
            return_states=False):
    """tokens (B,S) -> logits (B,S,V) (or (B,1,V) with ``last_only``);
    with ``return_states`` also the state tree after the last position.
    S must be a multiple of ``min(256, S)``. ``remat`` recomputes each
    group in the backward (``common.remat_call``)."""
    G, _ = _group_counts(cfg)
    h = T.embed_tokens(cfg, params, batch["tokens"])
    states = []
    for gp in unstack(params["groups"]):
        h = ctx.constrain(h)
        h, st = remat_call(remat, _group_apply, cfg, gp, h)
        states.append(st)
    h = T._normed(cfg, params["final_norm"], h)
    if last_only:
        h = h[:, -1:]
    logits = h @ params["lm_head"]
    if return_states:
        return logits, _stack_trees(states)
    return logits


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """The state tree's ``(shape, dtype)`` leaves (``max_len`` is not
    read: the state does not grow)."""
    G, n_m = _group_counts(cfg)
    D, Di, H, dh, _ = _dims(cfg)
    cw = cfg.conv_width
    f32 = torch.float32
    return {
        "mlstm": {"C": ((G, n_m, batch, H, dh, dh), f32),
                  "n": ((G, n_m, batch, H, dh), f32),
                  "conv": ((G, n_m, batch, cw - 1, Di), torch.bfloat16)},
        "slstm": {k: ((G, batch, D), f32) for k in ("h", "c", "n", "m")},
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zeros, the sLSTM normaliser n at 1e-6; on a mesh step, DTensors in
    the cache placements (``ctx.cache_zeros``)."""
    c = {k: {name: ctx.cache_zeros((k, name), *sd, device)
             for name, sd in leaves.items()}
         for k, leaves in cache_spec(cfg, batch, max_len).items()}
    c["slstm"]["n"] += 1e-6
    return c


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, max_len: int):
    """tokens (B,S) -> (last-token logits (B,V), the state tree)."""
    logits, states = forward(cfg, params, {"tokens": tokens}, last_only=True,
                             return_states=True)
    return logits[:, -1], states


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """tokens (B,1) -> (logits (B,V), the new state tree). ``pos`` is not
    read: the recurrence carries the position."""
    G, _ = _group_counts(cfg)
    h = T.embed_tokens(cfg, params, tokens)
    states = []
    for g in range(G):
        h, st = _group_apply(cfg, _take(params["groups"], g), h,
                             _take(cache, g))
        states.append(st)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return (h @ params["lm_head"])[:, 0], _stack_trees(states)
