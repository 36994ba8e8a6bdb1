"""Device meshes over the running process group (counterpart of
``repro.launch.mesh``).

A JAX mesh is an array of devices that one controller drives; a PyTorch
``DeviceMesh`` is an array of the ranks of a ``torch.distributed`` group,
one process a rank. ``init_distributed`` starts that group (from
``torchrun``'s environment, or from a ``file://`` store in tests); the
builders here lay its ranks out row-major, as ``jax.make_mesh`` lays out
its devices. Importing this module starts nothing and touches no device.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def init_distributed(backend: Optional[str] = None, store: Optional[str] = None,
                     *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     device: Optional[torch.device] = None) -> int:
    """Start this process's group, once: from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or, with
    ``store`` (a ``file://`` URL), from that store and the ``rank`` /
    ``world_size`` given. The backend defaults to NCCL for a CUDA
    ``device`` and gloo otherwise; NCCL binds the group to the device.
    Returns this process's rank."""
    if dist.is_initialized():
        return dist.get_rank()
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device is not None and device.type == "cuda" \
            else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("init_distributed: a store needs rank and "
                             "world_size")
        dist.init_process_group(backend, init_method=store, rank=rank,
                                world_size=world_size, **kw)
    else:
        if "RANK" not in os.environ:
            raise RuntimeError(
                "init_distributed: no RANK in the environment: run under "
                "torchrun, or pass a file:// store with rank and world_size")
        dist.init_process_group(backend, **kw)
    return dist.get_rank()


def _device_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_device_mesh(shape: Sequence[int], axes: Sequence[str],
                     ranks: Sequence[int], device=None):
    """A mesh over an explicit subset of the group's ranks, laid out
    row-major into ``shape``; every rank of the group must call it (the
    group is created collectively)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = 1
    for s in shape:
        n *= s
    if len(ranks) != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, got {len(ranks)}")
    return DeviceMesh(_device_type(device),
                      torch.tensor(list(ranks)).reshape(shape),
                      mesh_dim_names=axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A mesh over the whole group, whose world size must be the mesh's
    size (JAX's ``make_mesh`` takes every device of the process)."""
    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"mesh {tuple(shape)} needs a group of {n} ranks; "
                         f"the group has {world}")
    return make_device_mesh(shape, axes, range(n), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data', 'model'):
    raises, naming the world size, unless the group has 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def single_device_mesh(device=None):
    return make_mesh((1, 1), ("data", "model"), device)
