"""On-disk expert store: one raw tensor file and one JSON manifest per
expert (counterpart of ``repro.store.disk``, in the same file format).

Every leaf's bytes are appended to ``<name>.bin`` at a 64-byte-aligned
offset; ``<name>.json`` holds ``{"manifest", "total_bytes", "nbytes"}``, the
manifest mirroring the tree (dict keys sorted, ``{"__list__": [...]}`` and
``{"__tuple__": [...]}`` for sequences) with ``{"__tensor__": {"offset",
"shape", "dtype"}}`` at each leaf. Dtype names are numpy's (``"float32"``,
``"int32"``; bf16 is ``"bfloat16"``, ml_dtypes' name), so a directory that
the JAX package's ``MmapFileStore`` wrote reads here, and the other way
round.

``get`` maps the file with ``np.memmap`` and returns zero-copy CPU tensors
over it, so the disk read is demand-paged by the host-to-device copy that
follows it in the cache's load (it lands in that copy's ``h2d`` span).
Those pages are pageable memory, so the copy is not asynchronous as it is
from the pinned ``HostMemoryStore``. ``eager=True`` copies the tree into
memory inside ``get`` instead, which moves the read into the ``store_read``
span. The map is copy-on-write (``mode="c"``): the tensors are writable, as
``torch.from_numpy`` wants, and a write never reaches the file.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.store.base import ExpertStore

_ALIGN = 64
_LEAF_KEY = "__tensor__"
# torch dtype -> numpy's name for it (the manifest's dtype field)
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_TORCH = {v: k for k, v in _NAMES.items()}


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=_TORCH[name]).element_size()


def _leaf_array(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as a contiguous host array (bf16 as its 16 bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _flatten(node, f, offset: int):
    """Returns (manifest node, next offset), writing leaf bytes to ``f`` one
    leaf at a time."""
    if isinstance(node, dict):
        man = {}
        for k in sorted(node):
            man[k], offset = _flatten(node[k], f, offset)
        return man, offset
    if isinstance(node, (list, tuple)):
        items = []
        for x in node:
            m, offset = _flatten(x, f, offset)
            items.append(m)
        return {"__list__" if isinstance(node, list) else "__tuple__":
                items}, offset
    t = torch.as_tensor(node)
    pad = (-offset) % _ALIGN
    if pad:
        f.write(b"\0" * pad)
        offset += pad
    raw = _leaf_array(t)
    f.write(memoryview(raw.reshape(-1)).cast("B"))
    rec = {_LEAF_KEY: {"offset": offset, "shape": list(t.shape),
                       "dtype": _NAMES[t.dtype]}}
    return rec, offset + raw.nbytes


def _unflatten(man, buf: np.ndarray):
    if _LEAF_KEY in man:
        rec = man[_LEAF_KEY]
        dt = _TORCH[rec["dtype"]]
        n = int(np.prod(rec["shape"])) if rec["shape"] else 1
        start = rec["offset"]
        raw = buf[start:start + n * _itemsize(rec["dtype"])]
        if dt == torch.bfloat16:
            t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(raw.view(np.dtype(rec["dtype"])))
        return t.reshape(rec["shape"])
    if "__list__" in man:
        return [_unflatten(m, buf) for m in man["__list__"]]
    if "__tuple__" in man:
        return tuple(_unflatten(m, buf) for m in man["__tuple__"])
    return {k: _unflatten(v, buf) for k, v in man.items()}


def _manifest_nbytes(man) -> int:
    if _LEAF_KEY in man:
        rec = man[_LEAF_KEY]
        n = int(np.prod(rec["shape"])) if rec["shape"] else 1
        return n * _itemsize(rec["dtype"])
    if "__list__" in man or "__tuple__" in man:
        return sum(_manifest_nbytes(m)
                   for m in man.get("__list__", man.get("__tuple__")))
    return sum(_manifest_nbytes(v) for v in man.values())


class MmapFileStore(ExpertStore):
    """Raw-file capacity tier over nested dict / list / tuple trees of
    tensors, the shape of this package's model params."""

    def __init__(self, root, *, eager: bool = False):
        super().__init__()
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.eager = eager
        self._meta: Dict[str, dict] = {}     # manifest cache
        for mf in self.root.glob("*.json"):
            self._meta[mf.stem] = json.loads(mf.read_text())

    def _paths(self, name: str):
        return self.root / f"{name}.bin", self.root / f"{name}.json"

    def put(self, name, tree):
        bin_path, man_path = self._paths(name)
        # a new file replaces the old one, so a map a reader still holds
        # keeps the bytes it mapped
        tmp = bin_path.with_suffix(".bin.tmp")
        with open(tmp, "wb") as f:
            man, total = _flatten(tree, f, 0)
        os.replace(tmp, bin_path)
        doc = {"manifest": man, "total_bytes": total,
               "nbytes": _manifest_nbytes(man)}
        man_path.write_text(json.dumps(doc))
        self._meta[name] = doc
        self._note_write(total)

    def get(self, name):
        doc = self._meta[name]
        bin_path, _ = self._paths(name)
        buf = np.memmap(bin_path, dtype=np.uint8, mode="c")
        tree = _unflatten(doc["manifest"], buf)
        if self.eager:
            tree = _map_leaves(lambda t: t.clone(), tree)
        self._note_read(doc["nbytes"])
        return tree

    def contains(self, name):
        return name in self._meta

    def delete(self, name):
        bin_path, man_path = self._paths(name)
        bin_path.unlink(missing_ok=True)
        man_path.unlink(missing_ok=True)
        self._meta.pop(name, None)

    def keys(self):
        return list(self._meta.keys())

    def nbytes(self, name):
        return self._meta[name]["nbytes"]

    def stored_bytes(self, name):
        return self._meta[name]["total_bytes"]


def _map_leaves(fn, node):
    """Apply ``fn`` to every leaf of a nested dict / list / tuple tree."""
    if isinstance(node, dict):
        return {k: _map_leaves(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_leaves(fn, x) for x in node)
    return fn(node)
