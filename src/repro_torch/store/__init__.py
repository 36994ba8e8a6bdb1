"""Capacity-tier expert stores (counterpart of ``repro.store``): the
paper's DDR tier, §III-B / §V-B.

  * ``HostMemoryStore``         — host memory (pinned with a card present),
    zero-copy reads;
  * ``MmapFileStore``           — a raw tensor file and a JSON manifest per
    expert, memory-mapped, demand-paged reads (JAX's file format);
  * ``Int8BlockQuantizedStore`` — int8 absmax blocks, dequantized at ``get``.

``core.switching.HBMWeightCache`` runs its prefetch pipeline against any of
them; ``make_store`` builds one from a spec string.
"""
from repro_torch.store.base import (ExpertStore, HostMemoryStore, StoreStats,
                                    host_tree_bytes)
from repro_torch.store.disk import MmapFileStore
from repro_torch.store.quantized import Int8BlockQuantizedStore


def make_store(spec: str = "host", *, root=None) -> ExpertStore:
    """Build a backend from a spec string: ``host`` | ``mmap[:root]`` |
    ``int8[:block_size]``. ``root`` is the directory for ``mmap`` when the
    spec does not name one."""
    kind, _, arg = spec.partition(":")
    if kind == "host":
        return HostMemoryStore()
    if kind == "mmap":
        path = arg or root
        if path is None:
            raise ValueError("mmap store needs a directory: 'mmap:/path'")
        return MmapFileStore(path)
    if kind == "int8":
        return Int8BlockQuantizedStore(int(arg) if arg else 64)
    raise ValueError(f"unknown store spec {spec!r}")


__all__ = ["ExpertStore", "HostMemoryStore", "MmapFileStore",
           "Int8BlockQuantizedStore", "StoreStats", "host_tree_bytes",
           "make_store"]
