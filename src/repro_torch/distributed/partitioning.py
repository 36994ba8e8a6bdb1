"""Logical-axis partitioning (counterpart of
``repro.distributed.partitioning``): maps ``ParamSpec`` logical axes onto
mesh axes.

Mesh contract (``launch.mesh``):
    single-pod: (16, 16)  ('data', 'model')
    multi-pod : (2, 16, 16) ('pod', 'data', 'model')

The rules are JAX's:

  * batch-like axes shard over ('pod', 'data');
  * the TP axes (``TP_AXES``, in this order: the first one that divides
    takes 'model') shard over 'model': q heads and the FFN hidden dim
    always (the configs are padded by ``configs.pad_for_tp``), kv heads and
    the vocab only where the axis divides them;
  * 'experts' shards over 'model' (EP) where it divides; then
    'expert_ffn' stays replicated inside each expert;
  * anything else replicates.

A spec is a ``PartitionSpec``, a tuple with one entry a tensor dim: a mesh
axis name, a tuple of them, or None; ``placements`` turns it into DTensor
placements on a ``DeviceMesh``. A mesh here is a ``DeviceMesh`` or any
object with JAX's ``axis_names`` and ``shape`` (a dict of axis sizes), as
the tests' fake production mesh.

The dense variants' leaves follow from their axes, as in JAX: ``bq`` /
``bk`` / ``bv`` shard with their heads, ``bi_gate`` / ``bi_up`` / ``bi``
with the FFN hidden dim, the output biases ``bo`` (``embed``) and the
LayerNorm's ``bias`` replicate, and a tied model's ``embed.tok`` is its
vocab-sharded head. The node's one-controller TP runner reads the answer
for one ``('model',)`` axis as a dim index (``leaf_shard_dim``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec

# logical axis -> mesh axis (None = replicate). Order matters for tensors
# carrying two shardable axes: earlier-listed axes win the mesh axis.
TP_AXES = ("experts", "q_heads", "kv_heads", "ffn", "expert_ffn", "vocab",
           "rnn", "mlstm_v", "mlstm_vh", "kv_seq")
BATCH_AXES = ("batch",)


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of names, or None
    (JAX's ``PartitionSpec``, a tuple as it is; a tuple of one name is that
    name, as JAX normalises it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def leaf_pspec(s: ParamSpec, mesh) -> PartitionSpec:
    """PartitionSpec for one ParamSpec leaf."""
    axes = mesh_axes(mesh)
    msize = axes.get("model")
    # EP for this leaf: an 'experts' dim that divides takes the model axis
    # and 'expert_ffn' replicates
    has_ep = msize is not None and any(
        ax == "experts" and dim % msize == 0
        for dim, ax in zip(s.shape, s.axes))
    model_used = False
    entries = []
    for dim, ax in zip(s.shape, s.axes):
        if ax in BATCH_AXES:
            da = data_axes(mesh)
            total = int(np.prod([axes[a] for a in da])) if da else 1
            entries.append(da if da and dim % total == 0 else None)
            continue
        if ax in TP_AXES and msize is not None and not model_used \
                and not (has_ep and ax == "expert_ffn") \
                and dim % msize == 0 and dim >= msize:
            entries.append("model")
            model_used = True
            continue
        entries.append(None)
    return P(*entries)


def _spec_map(fn, specs):
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _spec_map(fn, v) for k, v in specs.items()}


def param_pspecs(specs, mesh):
    """A PartitionSpec tree matching a ParamSpec tree."""
    return _spec_map(lambda s: leaf_pspec(s, mesh), specs)


class _ModelAxis:
    """A one-axis ``('model',)`` mesh of ``tp`` ranks (the node's group)."""

    def __init__(self, tp: int):
        self.axis_names, self.shape = ("model",), {"model": tp}


def _model_dim(pspec: PartitionSpec) -> Optional[int]:
    return pspec.index("model") if "model" in pspec else None


def leaf_shard_dim(s: ParamSpec, tp: int) -> Optional[int]:
    """The dim of leaf ``s`` that shards over ``tp`` ranks, or None: the dim
    ``leaf_pspec`` names ``'model'`` on a ``('model',)`` mesh of ``tp``."""
    return _model_dim(leaf_pspec(s, _ModelAxis(tp)))


def param_shard_dims(specs, tp: int):
    """A tree of ``leaf_shard_dim`` matching a ``ParamSpec`` tree."""
    return _spec_map(lambda s: leaf_shard_dim(s, tp), specs)


# ----------------------------------------------------------------------
# cache shardings (per family)
# ----------------------------------------------------------------------

def cache_pspecs(cfg: ModelConfig, mesh) -> Any:
    """The decode cache's specs, one family at a time, as JAX's (its cache
    layouts: ``models.<family>.cache_spec``)."""
    from repro_torch.distributed import ctx
    axes = mesh_axes(mesh)
    dp = data_axes(mesh)
    dpp = dp if dp else None
    m = "model" if "model" in axes else None
    msize = axes["model"] if m else 1
    seq_shard = ctx.perf().cache_seq_shard

    if cfg.family in ("dense", "moe"):
        kv = m if (m and cfg.n_kv_heads % msize == 0) else None
        if kv is None and seq_shard and m:
            sp = P(None, dpp, m, None, None)     # context-parallel cache
        else:
            sp = P(None, dpp, None, kv, None)
        return {"k": sp, "v": sp}
    if cfg.family == "mla_moe":
        sp = (P(None, dpp, m, None) if (seq_shard and m)
              else P(None, dpp, None, None))
        out = {"ckv": sp, "krope": sp}
        if cfg.first_dense_layers:
            out["ckv0"] = sp
            out["krope0"] = sp
        return out
    if cfg.family == "encdec":
        kv = m if (m and cfg.n_kv_heads % msize == 0) else None
        sp = P(None, dpp, None, kv, None)
        return {"k": sp, "v": sp, "cross_k": sp, "cross_v": sp}
    if cfg.family == "rglru":
        from repro_torch.models.rglru import _group_counts
        rnn = m if (m and cfg.d_rnn % msize == 0) else None
        out = {
            "rec": {"h": P(None, None, dpp, rnn),
                    "conv": P(None, None, dpp, None, rnn)},
            "k": P(None, dpp, None, None, None),
            "v": P(None, dpp, None, None, None),
        }
        if _group_counts(cfg)[1]:
            out["tail"] = {"h": P(None, dpp, rnn),
                           "conv": P(None, dpp, None, rnn)}
        return out
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import _dims
        D, Di, H, dh, _ = _dims(cfg)
        v = m if (m and dh % msize == 0) else None
        vi = m if (m and Di % msize == 0) else None
        return {
            "mlstm": {"C": P(None, None, dpp, None, None, v),
                      "n": P(None, None, dpp, None, None),
                      "conv": P(None, None, dpp, None, vi)},
            "slstm": {k: P(None, dpp, None) for k in ("h", "c", "n", "m")},
        }
    raise KeyError(cfg.family)


def paged_pool_pspec(cfg: ModelConfig, mesh) -> PartitionSpec:
    """PartitionSpec of the serving-time paged KV pool, layout ``(layers,
    rows, block, kv_heads, head_dim)``: the kv heads shard over 'model'
    where it divides them, else the pool replicates (GQA kv < tp
    replicates the small KV rather than inflating the pool)."""
    axes = mesh_axes(mesh)
    m = "model" if "model" in axes else None
    msize = axes["model"] if m else 1
    kv = m if (m and cfg.n_kv_heads % msize == 0
               and cfg.n_kv_heads >= msize) else None
    return P(None, None, None, kv, None)


def paged_pool_shard_dim(cfg: ModelConfig, tp: int) -> Optional[int]:
    """The dim of the paged KV pool that shards over ``tp`` ranks (the
    node's form of ``paged_pool_pspec``): 3, the kv heads, or None."""
    return _model_dim(paged_pool_pspec(cfg, _ModelAxis(tp)))


def cache_layer_pspecs(cfg: ModelConfig, mesh) -> Dict[str, PartitionSpec]:
    """Per-layer cache-slice specs (leading layer/group dim stripped) for
    the in-loop constraints (``ctx.named_shardings``)."""
    cp = cache_pspecs(cfg, mesh)
    out: Dict[str, PartitionSpec] = {}
    if cfg.family in ("dense", "moe", "encdec", "rglru"):
        out["cache_kv"] = P(*cp["k"][1:])
    if cfg.family == "mla_moe":
        out["cache_mla"] = P(*cp["ckv"][1:])
    return out


def batch_pspecs(cfg: ModelConfig, batch: Dict[str, Any], mesh):
    """Every batch leaf shards its leading dim over the data axes."""
    dp = data_axes(mesh)
    dpp = dp if dp else None
    return {k: P(dpp, *([None] * (len(v.shape) - 1)))
            for k, v in batch.items()}


def fit_pspec(shape, pspec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop sharding on dims that the mesh axes do not divide evenly (e.g.
    batch 1); the result has ``shape``'s rank."""
    axes = mesh_axes(mesh)
    entries = []
    for i, entry in enumerate(pspec):
        if i >= len(shape):
            break
        if entry is None:
            entries.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        total = int(np.prod([axes[a] for a in names]))
        entries.append(entry if shape[i] % total == 0 and shape[i] >= total
                       else None)
    entries += [None] * (len(shape) - len(entries))
    return P(*entries)


def fit_pspec_tree(shape_tree, pspec_tree, mesh):
    """``fit_pspec`` leaf by leaf; a shape leaf is a shape tuple, a
    ``(shape, dtype)`` pair (a ``cache_spec`` entry) or a tensor."""
    if isinstance(pspec_tree, PartitionSpec):
        s = shape_tree
        if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], tuple):
            s = s[0]
        return fit_pspec(tuple(getattr(s, "shape", s)), pspec_tree, mesh)
    return {k: fit_pspec_tree(shape_tree[k], v, mesh)
            for k, v in pspec_tree.items()}


def placements(pspec: PartitionSpec, mesh):
    """DTensor placements of ``pspec`` on a ``DeviceMesh``: for each mesh
    axis, ``Shard(d)`` where tensor dim d names it, else ``Replicate()``.
    A dim named by several axes (('pod', 'data')) shards over them major
    to minor, as JAX lays it out. An axis of size 1 replicates: a shard
    over one rank is the whole tensor, and DTensor then has nothing to
    move over that axis."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dim = next((d for d, e in enumerate(pspec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None or size == 1 else Shard(dim))
    return tuple(out)


def pspec_tree_map(fn, tree):
    """``fn`` on every PartitionSpec of a nested-dict tree."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    return {k: pspec_tree_map(fn, v) for k, v in tree.items()}


class NamedSharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``); ``placements`` are its
    DTensor placements."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def shardings_from_pspecs(pspecs, mesh):
    return pspec_tree_map(lambda p: NamedSharding(mesh, p), pspecs)


def distribute(x, sharding: NamedSharding):
    """``x`` (the whole tensor, the same on every rank) as a DTensor with
    ``sharding``: each rank keeps its own shard, with no communication
    (JAX's ``device_put`` of a host array)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def placed(tree, pspecs, mesh):
    """A tree of DTensors with each leaf redistributed to its spec in
    ``pspecs`` (fitted to its shape), where it is not there already; a
    plain leaf (the whole tensor on every rank) is distributed."""
    if isinstance(pspecs, PartitionSpec):
        spec = fit_pspec(tuple(tree.shape), pspecs, mesh)
        pl = placements(spec, mesh)
        if not hasattr(tree, "placements"):
            return distribute(tree, NamedSharding(mesh, spec))
        return tree if tuple(tree.placements) == pl \
            else tree.redistribute(mesh, pl)
    return {k: placed(tree[k], v, mesh) for k, v in pspecs.items()}


def device_put(tree, shardings):
    """``distribute`` leaf by leaf over a tree of tensors and a matching
    tree of ``NamedSharding``s."""
    if isinstance(shardings, NamedSharding):
        return distribute(tree, shardings)
    return {k: device_put(tree[k], v) for k, v in shardings.items()}
