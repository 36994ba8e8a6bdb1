"""Memory tiers and the serving-time HBM split (own copies of
``repro.core.memory_tiers.MachineTiers``, its ``DGX_H100`` preset,
``HBMBudget`` and ``plan_hbm_budget``)."""
from __future__ import annotations

from dataclasses import dataclass

GiB = 1024 ** 3
GBps = 1e9


@dataclass(frozen=True)
class MemoryTier:
    name: str
    capacity: int          # bytes
    bandwidth: float       # bytes/s


@dataclass(frozen=True)
class MachineTiers:
    """Per-socket tiers + the capacity-tier -> HBM copy bandwidth per node."""
    name: str
    sram: MemoryTier
    hbm: MemoryTier
    capacity: MemoryTier
    copy_bw_node: float
    sockets_per_node: int
    peak_flops_bf16: float
    hbm_efficiency: float = 0.85


# published figures of a DGX H100 node, as the JAX package states them
DGX_H100 = MachineTiers(
    name="dgx-h100",
    sram=MemoryTier("sram", int(0.05 * GiB), 400e12),
    hbm=MemoryTier("hbm", 80 * GiB, 3.35e12),
    capacity=MemoryTier("host", 2048 * GiB, 200 * GBps),
    copy_bw_node=64 * GBps,
    sockets_per_node=8,
    peak_flops_bf16=989e12,
    hbm_efficiency=0.5,
)


@dataclass(frozen=True)
class HBMBudget:
    """How one HBM tier is divided at serving time: ``weights_bytes`` caps
    the expert weight cache, ``kv_bytes`` the paged KV pool."""
    total_bytes: int
    weights_bytes: int
    kv_bytes: int

    def resident_experts(self, expert_bytes: int) -> int:
        return self.weights_bytes // max(expert_bytes, 1)

    def kv_blocks(self, block_bytes: int) -> int:
        return self.kv_bytes // max(block_bytes, 1)


def plan_hbm_budget(total_bytes: int, expert_bytes: int, block_bytes: int,
                    *, min_resident_experts: int = 2,
                    kv_fraction: float = 0.2) -> HBMBudget:
    """Split an HBM tier between the expert cache and the KV pool: reserve
    ``kv_fraction`` for KV, but never fewer than ``min_resident_experts``
    experts of weights and never less than one KV block."""
    if total_bytes < min_resident_experts * expert_bytes + block_bytes:
        raise MemoryError(
            f"HBM tier of {total_bytes} bytes cannot hold "
            f"{min_resident_experts} experts ({expert_bytes} B each) plus "
            f"one KV block ({block_bytes} B)")
    kv = int(total_bytes * kv_fraction)
    kv = min(kv, total_bytes - min_resident_experts * expert_bytes)
    kv = max(kv, block_bytes)
    return HBMBudget(total_bytes=total_bytes,
                     weights_bytes=total_bytes - kv, kv_bytes=kv)
