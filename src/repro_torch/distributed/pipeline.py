"""Pipeline parallelism over a mesh axis, GPipe schedule (counterpart of
``repro.distributed.pipeline``).

Each rank along the 'stage' axis holds one contiguous block of layers (its
stage's slice of the params); microbatch activations flow stage to stage
through point-to-point sends on a ring (``batch_isend_irecv``; the last
stage's send to the first is discarded there, as JAX's ring permute's is).
The paper's RDU maps pipeline stages spatially on-chip and streams
activations between sockets over P2P (§VII); on GPUs the sends ride NVLink
under NCCL.

Schedule: fill/drain loop, T = M + S - 1 ticks for M microbatches over S
stages. Stage s computes on tick t iff s <= t < s + M. The last stage's
outputs are broadcast to every rank of the axis, as JAX's ``psum`` leaves
them replicated.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.bridge import tree_leaves, tree_map


def _stage_slice(stage_params, s: int):
    """This rank's slice: a DTensor sharded over the stage axis gives its
    one local slice; a plain tensor stacked on S its slice ``s``."""
    from torch.distributed.tensor import DTensor

    def take(a):
        if isinstance(a, DTensor):
            local = a.to_local()
            if local.shape[0] != 1:
                raise ValueError(f"pipeline_apply: a stage holds one slice, "
                                 f"got {local.shape[0]}")
            return local[0]
        return a[s]
    return tree_map(take, stage_params)


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, *, axis: str = "stage"):
    """``y = stage_{S-1}(...stage_0(x))`` as a pipeline over mesh axis
    ``axis``.

    stage_fn(params_slice, microbatch) -> microbatch (same shape).
    stage_params: a tree whose leaves are stacked on a leading dim S (one
    slice a stage), as DTensors ``Shard(0)`` over ``axis`` or as plain
    tensors every rank holds (each reads its own slice only).
    x: (M, ...) microbatches, M >= 1, the same on every rank (stage 0
    reads it). Returns (M, ...) outputs on every rank of the axis."""
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    s = mesh.get_local_rank(axis)
    M = x.shape[0]
    T = M + S - 1
    params = _stage_slice(stage_params, s)
    nxt = dist.get_global_rank(group, (s + 1) % S)
    prv = dist.get_global_rank(group, (s - 1) % S)
    last = dist.get_global_rank(group, S - 1)

    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    recv = torch.empty_like(buf)
    for t in range(T):
        if s == 0 and t < M:
            buf = x[t].clone()                  # stage 0 ingests microbatch t
        if s <= t < s + M:
            buf = stage_fn(params, buf).contiguous()
        if s == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = buf             # the last stage emits
        if S > 1:
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, buf, nxt),
                dist.P2POp(dist.irecv, recv, prv)])
            for r in reqs:
                r.wait()
            buf, recv = recv, buf
    if S > 1:
        dist.broadcast(outs, src=last, group=group)
    return outs


def sequential_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor):
    """Oracle: all stages applied in turn to each microbatch."""
    S = tree_leaves(stage_params)[0].shape[0]
    outs = []
    for mb in x:
        h = mb
        for i in range(S):
            h = stage_fn(tree_map(lambda a: a[i], stage_params), h)
        outs.append(h)
    return torch.stack(outs)
