from repro_torch.store.base import ExpertStore, HostMemoryStore, StoreStats

__all__ = ["ExpertStore", "HostMemoryStore", "StoreStats"]
