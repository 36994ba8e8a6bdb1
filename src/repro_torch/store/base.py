"""Capacity-tier expert store (counterpart of ``repro.store.base``).

The paper's third tier (a terabyte-class DDR per socket, §III-B, §V-B) holds
every expert of the composition; the HBM tier
(``core.switching.HBMWeightCache``) caches the active few. The contract the
cache and the composition program against:

  * ``put(name, tree)``    — persist one expert's tree of tensors;
  * ``get(name)``          — read it back as a tree of CPU tensors;
  * ``nbytes(name)``       — bytes as loaded into device memory (the cache's
    accounting unit: the dequantized size for the int8 store);
  * ``stored_bytes(name)`` — bytes the store occupies on the capacity tier
    (below ``nbytes`` for the int8 store: the paper's lever of hosting more
    experts than the tier naively fits).

Backends: ``HostMemoryStore`` (here: host memory, page-locked when a card is
present, so a prefetch's host-to-device copy runs asynchronously),
``store.disk.MmapFileStore`` (one raw file and a JSON manifest per expert,
JAX's on-disk format, memory-mapped reads) and
``store.quantized.Int8BlockQuantizedStore`` (int8 absmax blocks, dequantized
on the host at ``get``). ``get`` is safe to call from the prefetch thread;
``put`` and ``delete`` run on the caller's thread.
"""
from __future__ import annotations

import abc
import threading
from dataclasses import asdict, dataclass
from typing import Any, Dict, List

import torch

from repro_torch.bridge import tree_bytes, tree_map


@dataclass
class StoreStats:
    reads: int = 0
    writes: int = 0
    bytes_read: int = 0
    bytes_written: int = 0

    def as_dict(self):
        return asdict(self)


def host_tree_bytes(tree) -> int:
    """Logical bytes of a tree of tensors."""
    return tree_bytes(tree)


class ExpertStore(abc.ABC):
    """One expert-per-key store over trees of host tensors."""

    # True when nbytes() answers from metadata without reading the tree: the
    # cache pre-reserves HBM for a prefetch only from such stores
    cheap_nbytes = True

    def __init__(self):
        self.stats = StoreStats()
        self._stats_lock = threading.Lock()

    def _note_read(self, nbytes: int):
        with self._stats_lock:
            self.stats.reads += 1
            self.stats.bytes_read += nbytes

    def _note_write(self, nbytes: int):
        with self._stats_lock:
            self.stats.writes += 1
            self.stats.bytes_written += nbytes

    @abc.abstractmethod
    def put(self, name: str, tree: Any) -> None: ...

    @abc.abstractmethod
    def get(self, name: str) -> Any: ...

    @abc.abstractmethod
    def contains(self, name: str) -> bool: ...

    @abc.abstractmethod
    def delete(self, name: str) -> None: ...

    @abc.abstractmethod
    def keys(self) -> List[str]: ...

    @abc.abstractmethod
    def nbytes(self, name: str) -> int:
        """Bytes of the tree as ``get`` returns it (device-side size)."""

    def stored_bytes(self, name: str) -> int:
        """Bytes occupied on the capacity tier; defaults to ``nbytes``."""
        return self.nbytes(name)

    # -- conveniences shared by every backend ---------------------------
    def total_stored_bytes(self) -> int:
        return sum(self.stored_bytes(n) for n in self.keys())

    def __contains__(self, name: str) -> bool:
        return self.contains(name)

    def __len__(self) -> int:
        return len(self.keys())


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, page-locked when a card is present."""
    pin = torch.cuda.is_available()
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=pin)
    out.copy_(t)
    return out


class HostMemoryStore(ExpertStore):
    """Host-DRAM capacity tier. ``put`` copies the tree into host memory
    (pinned when a card is present; the source may lie on the card);
    ``get`` returns the stored tree without copying."""

    def __init__(self):
        super().__init__()
        self._trees: Dict[str, Any] = {}
        self._nbytes: Dict[str, int] = {}

    def put(self, name, tree):
        self._trees[name] = tree_map(_host_copy, tree)
        self._nbytes[name] = tree_bytes(self._trees[name])
        self._note_write(self._nbytes[name])

    def get(self, name):
        tree = self._trees[name]
        self._note_read(self._nbytes[name])
        return tree

    def contains(self, name):
        return name in self._trees

    def delete(self, name):
        del self._trees[name]
        del self._nbytes[name]

    def keys(self):
        return list(self._trees.keys())

    def nbytes(self, name):
        return self._nbytes[name]
