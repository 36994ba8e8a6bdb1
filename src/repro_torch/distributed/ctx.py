"""Activation-sharding context (counterpart of ``repro.distributed.ctx``):
lets the mesh builders impose a placement on the inter-layer residual
stream without threading mesh details through every model family.

Megatron-SP: during training the residual (B, S, D) is redistributed to
shard S over 'model' between layers, so the activations each layer saves
for the backward shrink by the TP degree; DTensor's sharding propagation
inserts the all-gather / reduce-scatter pairs around attention and the
MLP, as GSPMD does. The transformer places both itself, as torch TP's
sequence-parallel styles do: the all-gather of each normed input
(``gather_sequence``) and the reduce-scatter of each block's output
(``constrain``), since DTensor in torch 2.11 refuses an einsum whose input
or output gradient is sharded over S. Off a mesh (no DTensor) every
constraint is the identity, so the single-device paths keep their bits.

``PerfOptions`` holds JAX's nine fields with JAX's defaults. The port reads
every one that a JAX module reads: ``capacity_factor``, ``moe_ep_local``,
``cache_seq_shard``, ``onehot_xent``, ``activation_sp``, ``mlstm_bf16``
(``models/xlstm.py``), ``decode_cache_carry`` (``models/transformer.py``:
the decode loop's in-place cache is the carry's form) and
``moe_dispatch_constraint`` (``models/layers.py``'s mesh MoE,
``launch/dryrun.py``); ``perf_options`` refuses a non-default value of
``chunked_loss`` (``UNREAD``), which no JAX module reads either, naming the
field, instead of ignoring it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

# partitioning is imported where it is used: it imports models.common, and
# the models import this module (JAX's layout)
_ACTIVATION_PSPEC: Optional["PartitionSpec"] = None
_NAMED: dict = {}


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _redistribute(x, pspec: "PartitionSpec"):
    from repro_torch.distributed.partitioning import PartitionSpec, placements
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    if len(pspec) < x.dim():
        pspec = PartitionSpec(*pspec, *([None] * (x.dim() - len(pspec))))
    return x.redistribute(mesh, placements(pspec, mesh))


@contextlib.contextmanager
def activation_sharding(pspec: Optional["PartitionSpec"]):
    global _ACTIVATION_PSPEC
    prev = _ACTIVATION_PSPEC
    _ACTIVATION_PSPEC = pspec
    try:
        yield
    finally:
        _ACTIVATION_PSPEC = prev


@contextlib.contextmanager
def named_shardings(**pspecs):
    """Named placements for family-internal tensors (e.g. the per-layer KV
    cache slice of a decode step)."""
    global _NAMED
    prev = dict(_NAMED)
    _NAMED.update(pspecs)
    try:
        yield
    finally:
        _NAMED = prev


def reduce_like(y, x):
    """A DTensor ``y`` holding partial sums (a row-parallel projection's
    output) reduced to ``x``'s placements (the residual it joins);
    anything else as it is."""
    if is_dtensor(y) and is_dtensor(x) \
            and any(p.is_partial() for p in y.placements):
        return y.redistribute(y.device_mesh, x.placements)
    return y


def constrain(h, like=None):
    """The active activation placement on a (B, S, D) residual: a DTensor
    ``redistribute``; a plain tensor passes as it is. With no active spec,
    ``reduce_like(h, like)`` where ``like`` (the residual h joins) is
    given, else h as it is."""
    if _ACTIVATION_PSPEC is None:
        return h if like is None else reduce_like(h, like)
    return _redistribute(h, _ACTIVATION_PSPEC)


def gather_sequence(h):
    """Megatron-SP's all-gather ahead of the column-parallel projections
    (torch TP's ``desired_input_layouts=Replicate()``): a (B, S, D) DTensor
    whose S is sharded, while an activation spec is active, gets S
    replicated; anything else passes as it is. GSPMD places this gather
    itself; DTensor in torch 2.11 refuses the einsum instead, whose
    decomposition flattens (B, S) with S sharded."""
    if _ACTIVATION_PSPEC is None or not is_dtensor(h):
        return h
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in h.placements]
    return h.redistribute(h.device_mesh, pl)


def named(name: str):
    """The active named placement ``name`` (a ``PartitionSpec``), or None."""
    return _NAMED.get(name)


def constrain_named(name: str, x):
    p = _NAMED.get(name)
    if p is None:
        return x
    return _redistribute(x, p)


def cache_zeros(key, shape, dtype, device):
    """A zero cache leaf ``key`` (a name, or the tuple of names down a
    nested cache): on a mesh with a named ``cache`` spec tree (the mesh
    serving steps), a DTensor placed by the fitted spec of ``key``, each
    rank allocating only its shard; else a plain tensor."""
    spec = _NAMED.get("cache") or {}
    for k in (key,) if isinstance(key, str) else key:
        spec = spec.get(k) if isinstance(spec, dict) else None
    if spec is None or _MESH is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros

    from repro_torch.distributed.partitioning import fit_pspec, placements
    spec = fit_pspec(tuple(shape), spec, _MESH)
    return zeros(tuple(shape), dtype=dtype, device_mesh=_MESH,
                 placements=placements(spec, _MESH))


# ----------------------------------------------------------------------
# Perf options (JAX's hill-climb knobs). Defaults = the paper-faithful
# baseline.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PerfOptions:
    # decode: shard the KV-cache sequence dim over 'model' when kv-heads
    # can't shard (flash-decode context parallelism; GQA kv<16 archs)
    cache_seq_shard: bool = False
    # train: Megatron-SP sequence-sharded residuals between layers
    activation_sp: bool = True
    # MoE: pin dispatch buffers so EP resolves to all-to-all, not gathers
    moe_dispatch_constraint: bool = False
    # MoE: capacity factor override (0 = keep config)
    capacity_factor: float = 0.0
    # train: chunked-vocab cross entropy (never materialize full logits)
    chunked_loss: bool = False
    # MoE: local EP dispatch (no global sort/scatter collectives)
    moe_ep_local: bool = False
    # loss: select gold logits via iota-compare (shardable over vocab)
    # instead of a gather of the sharded logits
    onehot_xent: bool = False
    # decode: thread the full KV cache through the layer loop as a carry
    decode_cache_carry: bool = False
    # xlstm: bf16 chunkwise mLSTM compute (f32 gates/state only)
    mlstm_bf16: bool = False


# the fields no module of the port reads: chunked_loss, which no module
# of JAX's reads either
UNREAD = ("chunked_loss",)

_PERF = PerfOptions()


@contextlib.contextmanager
def perf_options(opts: PerfOptions):
    global _PERF
    for name in UNREAD:
        if getattr(opts, name) != getattr(PerfOptions(), name):
            raise NotImplementedError(
                f"PerfOptions.{name}={getattr(opts, name)!r}: the port does "
                "not read this field (nor does the JAX package)")
    prev = _PERF
    _PERF = opts
    try:
        yield
    finally:
        _PERF = prev


def perf() -> PerfOptions:
    return _PERF


def moe_dispatch_named(cfg, mesh) -> dict:
    """The named placements of JAX's ``launch/dryrun.py::_lower_for`` under
    ``moe_dispatch_constraint``: the MoE dispatch and result buffers (E, C,
    D) by expert over 'model', where the 'model' axis divides the experts
    (``{"moe_dispatch": P("model", None, None)}``); else none."""
    from repro_torch.distributed.partitioning import PartitionSpec
    names = mesh.mesh_dim_names
    tp = mesh.shape[names.index("model")] if "model" in names else 1
    if perf().moe_dispatch_constraint and cfg.n_experts \
            and cfg.n_experts % tp == 0:
        return {"moe_dispatch": PartitionSpec("model", None, None)}
    return {}


_MESH = None


@contextlib.contextmanager
def mesh_ctx(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def current_mesh():
    return _MESH
