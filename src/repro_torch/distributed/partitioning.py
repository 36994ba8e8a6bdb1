"""Which dim of a parameter shards over a socket group's tensor-parallel
ranks (the serving subset of ``repro.distributed.partitioning``).

JAX maps each ``ParamSpec``'s logical axes onto a ``('model',)`` mesh axis
and returns a ``PartitionSpec``; the port's single controller needs only the
answer for one group of ``tp`` ranks: the index of the dim that shards, or
None (replicated). The rules are JAX's:

  * the TP axes (``TP_AXES``, in this order: the first one that divides
    takes the group) shard over the ranks: q heads and the FFN hidden dim
    always (the configs are padded by ``configs.pad_for_tp``), kv heads and
    the vocab only where ``tp`` divides them;
  * anything else replicates.

The dense variants' leaves follow from their axes, as in JAX: ``bq`` /
``bk`` / ``bv`` shard with their heads, ``bi_gate`` / ``bi_up`` / ``bi``
with the FFN hidden dim, the output biases ``bo`` (``embed``) and the
LayerNorm's ``bias`` replicate, and a tied model's ``embed.tok`` is its
vocab-sharded head.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec

# the JAX package's TP axes, in its order: an earlier axis wins the group
TP_AXES = ("experts", "q_heads", "kv_heads", "ffn", "expert_ffn", "vocab",
           "rnn", "mlstm_v", "mlstm_vh", "kv_seq")


def leaf_shard_dim(s: ParamSpec, tp: int) -> Optional[int]:
    """The dim of leaf ``s`` that shards over ``tp`` ranks, or None (JAX's
    ``leaf_pspec`` on a one-axis ``model`` mesh of size ``tp``: the dim
    named ``'model'`` there)."""
    has_ep = any(ax == "experts" and dim % tp == 0
                 for dim, ax in zip(s.shape, s.axes))
    for i, (dim, ax) in enumerate(zip(s.shape, s.axes)):
        if ax not in TP_AXES or (has_ep and ax == "expert_ffn"):
            continue
        if dim % tp == 0 and dim >= tp:
            return i
    return None


def param_shard_dims(specs, tp: int):
    """A tree of ``leaf_shard_dim`` matching a ``ParamSpec`` tree."""
    if isinstance(specs, ParamSpec):
        return leaf_shard_dim(specs, tp)
    return {k: param_shard_dims(v, tp) for k, v in specs.items()}


def paged_pool_shard_dim(cfg: ModelConfig, tp: int) -> Optional[int]:
    """The dim of the paged KV pool ``(layers, rows, block, kv_heads,
    head_dim)`` that shards over ``tp`` ranks: the kv heads where ``tp``
    divides them, else None (GQA kv < tp replicates the small KV rather
    than inflating the pool; JAX's ``paged_pool_pspec``)."""
    if cfg.n_kv_heads % tp == 0 and cfg.n_kv_heads >= tp:
        return 3
    return None
