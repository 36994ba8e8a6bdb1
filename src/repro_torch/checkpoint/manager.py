"""Atomic checkpointing (counterpart of ``repro.checkpoint.manager``), in
the JAX package's on-disk format, so that a checkpoint written by either
package restores in the other bit for bit.

Checkpoints are keyed by the logical tree: each leaf is written as one
``.npy`` inside a staging directory, which is then renamed into place; a
``latest`` marker is written last, so a crash mid-write never corrupts a
restore. Keys are JAX's ``tree_flatten_with_path`` names: dict keys in
sorted order joined by ``/`` (list and tuple entries by index), with
``/`` -> ``__`` in file names. bf16 is stored as its uint16 bit pattern
with ``"dtype": "bfloat16"`` in the manifest (numpy has no bfloat16); it is
read back through torch views, not ``ml_dtypes``. A retention policy keeps
the last ``keep`` checkpoints. Restore places the leaves on a device given
by the caller, or distributes them over a mesh (JAX's takes shardings).

A state of DTensors (a mesh step's) is saved whole: every rank gathers
each leaf (``full_tensor``, a collective, leaf by leaf), rank 0 writes it
in the same format, and the ranks meet at a barrier. Restoring it with
shardings on another mesh is elastic: each rank reads every leaf and keeps
its own shard, so a state saved on one mesh restores bit for bit onto any
other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.ctx import is_dtensor


def _flatten(tree, prefix=(), sharding_leaves=False):
    """[(key, leaf)] in JAX's flatten order: dict keys sorted, sequences by
    index, ``None`` an empty subtree (a ``NamedSharding`` a leaf with
    ``sharding_leaves``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),),
                                   sharding_leaves)]
    if isinstance(tree, (list, tuple)) and not (
            sharding_leaves and hasattr(tree, "placements")):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),), sharding_leaves)]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves: Dict[str, Any], prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)) and not hasattr(like, "placements"):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves["/".join(prefix)]


def _sharded(leaves) -> bool:
    return any(is_dtensor(v) for _, v in leaves)


def _to_host(leaf, copy: bool = False) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array; bf16 as its
    uint16 bits. With ``copy`` a host tensor is copied too, so the result
    does not change with it. A DTensor is gathered whole first (every rank
    of its mesh must call this)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _is_bf16(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype == torch.bfloat16
    dt = np.asarray(leaf).dtype
    return dt.kind == "V" or "bfloat16" in str(dt)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread = None
        self._barrier = False

    @staticmethod
    def _root() -> bool:
        """Whether this process writes: rank 0 of a running group, or the
        only process."""
        import torch.distributed as dist
        return not dist.is_initialized() or dist.get_rank() == 0

    # -- async save (training never blocks on the filesystem) -------------
    def save_async(self, step: int, state: Any, extra: Optional[Dict] = None):
        """The device -> host copy happens now; the filesystem write runs on
        a background thread. Joins any previous in-flight save first (at
        most one outstanding). A sharded state is gathered on every rank
        and written by rank 0; ``wait`` then holds the ranks at a barrier
        until the write is done."""
        leaves = _flatten(state)
        sharded = _sharded(leaves)
        host = [(k, _to_host(v, copy=True), _is_bf16(v)) for k, v in leaves]
        self.wait()
        if sharded and not self._root():
            self._barrier = True
            return
        self._async_thread = threading.Thread(
            target=self._write, args=(step, host, extra), daemon=True)
        self._async_thread.start()
        self._barrier = sharded

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()

    # -- save ------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        """Write ``state`` at ``step``; returns the checkpoint's directory.
        A sharded state: every rank gathers, rank 0 writes, then a
        barrier."""
        leaves = _flatten(state)
        if not _sharded(leaves):
            return self._write(step, ((k, v, _is_bf16(v))
                                      for k, v in leaves), extra)
        import torch.distributed as dist
        gathered = ((k, _to_host(v), _is_bf16(v)) for k, v in leaves)
        if self._root():
            final = self._write(step, gathered, extra)
        else:
            for _ in gathered:                # the gathers are collectives
                pass
            final = self.dir / f"step-{step:09d}"
        dist.barrier()
        return final

    def _write(self, step, leaves, extra):
        stage = self.dir / f".tmp-{step}-{os.getpid()}"
        final = self.dir / f"step-{step:09d}"
        if stage.exists():
            shutil.rmtree(stage)
        stage.mkdir(parents=True)
        manifest = {"step": step, "keys": [], "time": time.time(),
                    "extra": extra or {}}
        for key, leaf, bf16 in leaves:
            host = _to_host(leaf)
            if bf16:
                host = host.view(np.uint16)
            fn = key.replace("/", "__") + ".npy"
            np.save(stage / fn, host)
            manifest["keys"].append({"key": key, "file": fn,
                                     "shape": list(host.shape),
                                     "dtype": "bfloat16" if bf16
                                     else str(host.dtype)})
            del host
        (stage / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        stage.rename(final)                       # atomic publish
        (self.dir / "latest").write_text(final.name)
        self._gc()
        return final

    def _gc(self):
        ckpts = sorted(self.dir.glob("step-*"))
        for old in ckpts[: max(0, len(ckpts) - self.keep)]:
            shutil.rmtree(old)

    # -- restore -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        marker = self.dir / "latest"
        if not marker.exists():
            return None
        name = marker.read_text().strip()
        if not (self.dir / name).exists():
            ckpts = sorted(self.dir.glob("step-*"))
            if not ckpts:
                return None
            name = ckpts[-1].name
        return int(name.split("-")[1])

    def restore(self, step: Optional[int], like: Any, device=None,
                shardings=None):
        """Restore into the structure of ``like`` (a tree of tensors, or of
        anything where only the structure is read). Each leaf goes to
        ``device``, or, where that is None, to the ``like`` leaf's device
        (the CPU for a leaf that is not a tensor). With ``shardings`` (a
        tree of ``partitioning.NamedSharding`` matching ``like``; it may be
        ``like`` itself), or where a ``like`` leaf is a DTensor, the leaf is
        distributed over that mesh instead: each rank keeps its shard.
        Returns (state, manifest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        final = self.dir / f"step-{step:09d}"
        manifest = json.loads((final / "manifest.json").read_text())
        by_key = {e["key"]: e for e in manifest["keys"]}
        placed = dict(_flatten(shardings, sharding_leaves=True)) \
            if shardings is not None else {}
        leaves = {}
        for key, leaf in _flatten(like, sharding_leaves=True):
            ent = by_key[key]
            host = np.load(final / ent["file"])
            if ent["dtype"] == "bfloat16":
                t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(host)
            if key in placed or is_dtensor(leaf):
                leaves[key] = _distribute(t, placed.get(key), leaf)
            else:
                dev = device if device is not None else (
                    leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
                leaves[key] = t.to(dev)
            del host
        return _unflatten(like, leaves), manifest

    def restore_state(self, like, device=None, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, 0
        state, manifest = self.restore(step, like, device, shardings)
        return state, manifest["step"]


def _distribute(t: torch.Tensor, sharding, like):
    """The whole leaf ``t`` (host) as a DTensor: with ``sharding``'s mesh and
    placements, else ``like``'s; on the mesh's device type (the current
    CUDA device for a CUDA mesh)."""
    from torch.distributed.tensor import distribute_tensor
    if sharding is not None:
        mesh, pl = sharding.mesh, sharding.placements
    else:
        mesh, pl = like.device_mesh, like.placements
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return distribute_tensor(t.to(dev), mesh, pl, src_data_rank=None)
