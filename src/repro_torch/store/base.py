"""Capacity-tier expert store (counterpart of ``repro.store.base``).

The paper's third tier holds every expert of the composition; the HBM tier
(``core.switching.HBMWeightCache``) caches the active few. ``put`` persists
one expert's tree of tensors, ``get`` reads it back, ``nbytes`` is its size
as loaded into device memory.

``HostMemoryStore`` keeps the trees in page-locked (pinned) host memory
whenever a card is present, so the host-to-device copy of a prefetch runs
asynchronously on a side stream. The mmap and int8 stores are not ported yet
(``ROADMAP.md``).
"""
from __future__ import annotations

import abc
import threading
from dataclasses import asdict, dataclass
from typing import Any, Dict

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


class ExpertStore(abc.ABC):
    """One expert-per-key store over trees of host tensors."""

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
    def nbytes(self, name: str) -> int: ...

    def stored_bytes(self, name: str) -> int:
        """Bytes occupied on the capacity tier; defaults to ``nbytes``."""
        return self.nbytes(name)


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

    def nbytes(self, name):
        return self._nbytes[name]
