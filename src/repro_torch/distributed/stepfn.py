"""The train, prefill and decode steps (counterpart of
``repro.distributed.stepfn``): the loss, and the step builders on one device
or on a mesh.

The state is ``{"params", "opt": {"mu", "nu", "step"}}``; a step takes the
gradient of the mean token cross-entropy of ``model.forward(params, batch,
remat=remat)`` by autograd and applies ``optim.adamw_update``, which
updates the params and moments in place (see ``optim.adamw``). On the card
the forward's attention runs the ``flash_prefill`` kernel's LSE form and
its backward the ``flash_prefill_bwd`` kernels (``kernels.flash_attention.
ops.FlashAttention``); a kernel with no backward raises under grad instead
of leaving the weights upstream without a gradient.

With a ``mesh`` (a ``DeviceMesh`` over the process group, ``launch.mesh``)
the builders return JAX's triples, their shardings ``partitioning.
NamedSharding`` trees: params and moments are DTensors placed by
``partitioning.leaf_pspec``, the batch shards over the data axes, and the
model runs unchanged under ``implicit_replication`` (its plain position
and mask tensors count as replicated); DTensor's sharding propagation
inserts the collectives, as GSPMD does, and ``layers.attention`` /
``layers.moe_apply`` run each rank's shard through ``local_map``. Each
gradient is redistributed to its param's placement before AdamW, which
sums a param's partial gradients over the data axes (the loss is the mean
over the global batch, so that sum is the data-parallel mean). In
training the residual between layers shards its sequence over 'model'
(Megatron-SP, ``ctx.activation_sharding``) while ``ctx.perf().
activation_sp`` is on.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.bridge import tree_from_items, tree_items
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.distributed import partitioning as part
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state


def softmax_xent(logits, targets):
    """Mean token cross-entropy; f32 logsumexp. With ``ctx.perf().
    onehot_xent`` the gold logit is selected by an iota compare
    (elementwise on vocab-sharded logits, its sum a partial reduction)
    instead of a gather (which, on a mesh, gathers the vocab-sharded
    logits first, as GSPMD's lowering of JAX's does, and takes each rank's
    rows through ``local_map``). The two are the same value."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    if ctx.perf().onehot_xent:
        hit = torch.arange(lf.shape[-1], device=lf.device) \
            == targets[..., None]
        gold = torch.sum(torch.where(hit, lf, 0.0), dim=-1)
    elif ctx.is_dtensor(lf):
        gold = _sharded_gold(lf, targets)
    else:
        gold = _gold(lf, targets)
    return torch.mean(lse - gold)


def _gold(lf, targets):
    return torch.gather(lf, -1, targets[..., None].long())[..., 0]


def _sharded_gold(lf, targets):
    """``_gold`` of DTensor logits: the vocab gathered, then each rank's
    rows through ``local_map``, the batch and sequence kept as they are
    sharded (DTensor's own rule for the gather's backward, a scatter,
    replicates the whole (B, S, V) gradient on every rank)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    mesh = lf.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == lf.ndim - 1
          else p for p in lf.placements]
    lf = lf.redistribute(mesh, pl)
    if not ctx.is_dtensor(targets):
        targets = distribute_tensor(targets, mesh, pl, src_data_rank=None)
    return local_map(_gold, out_placements=pl, in_placements=(pl, pl),
                     in_grad_placements=(pl, pl), device_mesh=mesh,
                     redistribute_inputs=True)(lf, targets)


def chunked_xent(cfg, model, params, h_fn, batch, n_chunks=8):
    """Cross-entropy without the full (B,S,V) logits at once: the final
    hidden states are unembedded and reduced a sequence chunk at a time."""
    from repro_torch.models import transformer as T
    h = h_fn()
    B, S, D = h.shape
    c = S // n_chunks
    total = 0.0
    for i in range(n_chunks):
        hs = h[:, i * c:(i + 1) * c]
        ts = batch["targets"][:, i * c:(i + 1) * c]
        lf = T.unembed(cfg, params, hs).float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, ts[..., None].long())[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (B * S)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    *, mesh=None, remat: bool = True, accum_steps: int = 1):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; with a
    ``mesh``, JAX's ``(step_fn, state_shardings, batch_shardings_fn)``, the
    state then a tree of DTensors placed by ``state_shardings``
    (``partitioning.device_put``) and the batch by ``batch_shardings_fn(
    batch)``.

    batch = {'tokens': (B,S), 'targets': (B,S)[, 'enc_embeds': ...]}, on
    the params' device. metrics: ``loss``, ``lr``, ``grad_norm`` (f32
    scalar tensors, plain on a mesh too). With ``accum_steps`` > 1 the
    batch splits into microbatches along dim 0 and their gradients are
    summed in f32, then divided by ``accum_steps`` before one optimizer
    step, as JAX's scan does. A param no loss reaches gets a zero
    gradient."""
    model = get_model(cfg)
    opt_cfg = opt_cfg or AdamWConfig()

    def loss_and_grads(params, batch):
        names, leaves = zip(*tree_items(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                logits = model.forward(params, batch, remat=remat)
                loss = softmax_xent(logits, batch["targets"])
                del logits
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        # on a mesh: each gradient in its param's placement (a partial sum
        # over the data axes reduced), before it is summed or applied
        grads = [g if g is None or not ctx.is_dtensor(g) else
                 g.redistribute(g.device_mesh, p.placements)
                 for g, p in zip(grads, leaves)]
        return loss.detach(), dict(zip(names, grads))

    def step_body(state, batch):
        params = state["params"]
        if accum_steps <= 1:
            loss, flat = loss_and_grads(params, batch)
        else:
            micro = [{k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                     for i in range(accum_steps)]
            loss, flat = 0.0, dict.fromkeys(n for n, _ in tree_items(params))
            for mb in micro:
                l, g = loss_and_grads(params, mb)
                loss = loss + l
                for n, x in g.items():
                    if x is not None:
                        flat[n] = x.float() if flat[n] is None \
                            else flat[n].add_(x.float())
                del g
            loss = loss / accum_steps
            flat = {n: None if x is None else x.div_(accum_steps)
                    for n, x in flat.items()}
        grads = tree_from_items(params, flat)
        del flat
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, params, grads, state["opt"])
        metrics = dict(metrics, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    if mesh is None:
        return step_body

    pspecs = part.param_pspecs(model.param_specs(), mesh)
    state_sh = state_shardings(pspecs, mesh)
    dp = part.data_axes(mesh)
    tp = part.mesh_axes(mesh).get("model", 1)
    act_ps = part.P(dp or None, "model" if tp > 1 else None, None)

    def step_fn(state, batch):
        with on_mesh(mesh), ctx.activation_sharding(
                act_ps if ctx.perf().activation_sp else None):
            state, metrics = step_body(state, batch)
        return state, {k: _plain(v) for k, v in metrics.items()}

    def batch_shardings(batch_tree):
        return part.shardings_from_pspecs(
            part.batch_pspecs(cfg, batch_tree, mesh), mesh)

    return step_fn, state_sh, batch_shardings


def kernel_launches(cfg: ModelConfig) -> dict:
    """The kernel launches one single-device train step of ``cfg`` (remat
    on, as ``make_train_step`` defaults) takes on the card, by launch count
    name: each attention's LSE forward (``flash_prefill[lse]``) twice, the
    forward and its recompute, and its backward (``flash_prefill_bwd``)
    once; each recurrent layer's ``lru_scan`` and ``lru_scan_bwd``
    likewise. Whisper's decoder layers attend twice (self and cross);
    xLSTM's blocks run no kernel."""
    if cfg.family == "rglru":
        pattern = [cfg.block_pattern[i % len(cfg.block_pattern)]
                   for i in range(cfg.n_layers)]
        n_attn, n_rec = pattern.count("attn"), pattern.count("rec")
    elif cfg.family == "encdec":
        n_attn, n_rec = cfg.n_encoder_layers + 2 * cfg.n_layers, 0
    elif cfg.family == "xlstm":
        n_attn, n_rec = 0, 0
    else:
        n_attn, n_rec = cfg.n_layers, 0
    return {"flash_prefill[lse]": 2 * n_attn, "flash_prefill_bwd": n_attn,
            "lru_scan": 2 * n_rec, "lru_scan_bwd": n_rec}


def _plain(x):
    """A replicated DTensor's value as a plain tensor; a plain one as it
    is."""
    return x.full_tensor() if ctx.is_dtensor(x) else x


@contextlib.contextmanager
def on_mesh(mesh):
    """The context the mesh builders run the model in: plain tensors count
    as replicated, and ``ctx.current_mesh()`` is ``mesh``."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), ctx.mesh_ctx(mesh):
        yield


def state_shardings(pspecs, mesh):
    """The train state's ``NamedSharding`` tree: params and both moments
    as ``pspecs``, the step replicated."""
    psh = part.shardings_from_pspecs(pspecs, mesh)
    return {"params": psh, "opt": {"mu": psh, "nu": psh,
                                   "step": part.NamedSharding(mesh, part.P())}}


class Abstract(NamedTuple):
    """A leaf's shape and type as a meta-device tensor, and its sharding
    (JAX's ``ShapeDtypeStruct`` with a sharding)."""
    value: torch.Tensor
    sharding: Any


def _abstract(shape, dtype, sharding):
    return Abstract(torch.empty(shape, dtype=dtype, device="meta"), sharding)


def abstract_train_state(cfg: ModelConfig, mesh):
    """The train state as ``Abstract`` leaves: the params' dtypes, f32
    moments, an int32 step."""
    from repro_torch.models.common import ParamSpec
    specs = get_model(cfg).param_specs()
    sh = state_shardings(part.param_pspecs(specs, mesh), mesh)

    def leaves(s, shard, f32):
        if isinstance(s, ParamSpec):
            return _abstract(s.shape, torch.float32 if f32 else s.dtype,
                             shard)
        return {k: leaves(s[k], shard[k], f32) for k in s}
    return {"params": leaves(specs, sh["params"], False),
            "opt": {"mu": leaves(specs, sh["opt"]["mu"], True),
                    "nu": leaves(specs, sh["opt"]["nu"], True),
                    "step": _abstract((), torch.int32, sh["opt"]["step"])}}


# ----------------------------------------------------------------------
# serving steps
# ----------------------------------------------------------------------

def _fitted_cache_pspecs(cfg, mesh, batch, max_len):
    cs = get_model(cfg).cache_spec(batch, max_len)
    return part.fit_pspec_tree(cs, part.cache_pspecs(cfg, mesh), mesh)


def _serving_shardings(cfg, mesh, batch, max_len):
    model = get_model(cfg)
    param_sh = part.shardings_from_pspecs(
        part.param_pspecs(model.param_specs(), mesh), mesh)
    cpsp = _fitted_cache_pspecs(cfg, mesh, batch, max_len)
    dp = part.data_axes(mesh)
    logits_sh = part.NamedSharding(mesh, part.fit_pspec(
        (batch, cfg.vocab_size), part.P(dp or None, None), mesh))
    return model, param_sh, cpsp, logits_sh


def _tokens_on_mesh(tokens, mesh):
    """Plain tokens (B, ...) sharded over the data axes where they divide
    B; DTensors as they are."""
    if ctx.is_dtensor(tokens):
        return tokens
    dp = part.data_axes(mesh)
    spec = part.fit_pspec(tuple(tokens.shape), part.P(dp or None), mesh)
    return part.distribute(tokens, part.NamedSharding(mesh, spec))


def make_prefill_step(cfg: ModelConfig, mesh, max_len: int, *,
                      batch: int = 0):
    """Returns ``(prefill_fn, param_shardings, cache_shardings)``;
    ``prefill_fn(params, batch) -> (last logits (B, V), cache)``: the
    model's ``prefill`` on the mesh, its cache made in ``cache_shardings``
    (the fitted ``cache_pspecs``) and the logits sharded over the data
    axes, the vocab whole."""
    model, param_sh, cpsp, logits_sh = _serving_shardings(
        cfg, mesh, batch or 8, max_len)

    def prefill_fn(params, batch):
        batch = {k: _tokens_on_mesh(v, mesh) if k == "tokens" else v
                 for k, v in batch.items()}
        with on_mesh(mesh), ctx.named_shardings(cache=cpsp):
            logits, cache = model.prefill(params, batch, max_len)
        return (logits.redistribute(mesh, logits_sh.placements),
                part.placed(cache, cpsp, mesh))

    return prefill_fn, param_sh, part.shardings_from_pspecs(cpsp, mesh)


def make_decode_step(cfg: ModelConfig, mesh, *, batch: int = 0,
                     max_len: int = 0):
    """Returns ``(decode_fn, param_shardings, cache_shardings)``;
    ``decode_fn(params, cache, tokens, pos) -> (logits (B, V), cache)``:
    the model's ``decode_step`` on the mesh, the cache (DTensors in
    ``cache_shardings``) written in place, with the per-layer cache
    placements named (``ctx.named_shardings``: ``cache_kv`` /
    ``cache_mla``)."""
    model, param_sh, cpsp, logits_sh = _serving_shardings(
        cfg, mesh, batch or 8, max_len or 1024)
    layer_ps = {}
    if cfg.family in ("dense", "moe", "encdec", "rglru"):
        layer_ps["cache_kv"] = part.P(*cpsp["k"][1:])
    if cfg.family == "mla_moe":
        layer_ps["cache_mla"] = part.P(*cpsp["ckv"][1:])

    def decode_fn(params, cache, tokens, pos):
        tokens = _tokens_on_mesh(tokens, mesh)
        with on_mesh(mesh), ctx.named_shardings(cache=cpsp, **layer_ps):
            logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits.redistribute(mesh, logits_sh.placements), cache

    return decode_fn, param_sh, part.shardings_from_pspecs(cpsp, mesh)


def abstract_cache(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """The decode cache as ``Abstract`` leaves with the fitted cache
    shardings (any family's ``cache_spec`` tree)."""
    cs = get_model(cfg).cache_spec(batch, max_len)
    cp = _fitted_cache_pspecs(cfg, mesh, batch, max_len)

    def leaves(s, p):
        if isinstance(p, part.PartitionSpec):
            return _abstract(s[0], s[1], part.NamedSharding(mesh, p))
        return {k: leaves(s[k], p[k]) for k in p}
    return leaves(cs, cp)


def init_train_state(params):
    """``{"params": params, "opt": init_opt_state(params)}``."""
    return {"params": params, "opt": init_opt_state(params)}
