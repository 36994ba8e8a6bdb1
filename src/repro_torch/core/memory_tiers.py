"""Memory tiers, the serving-time HBM split and the static lifetime
allocator (own copies of ``repro.core.memory_tiers.MachineTiers``, its
presets and ``MACHINES`` table, ``HBMBudget``, ``plan_hbm_budget``,
``Symbol``, ``Allocation``, ``allocate_static``, ``spill_order`` and
``plan_placement``).

The presets are the analytic model's published constants (paper Table II
and the DGX specifications it cites), not measurements of the port; the
port's node plans against ``DGX_H100``. The allocator is host-side
planning (paper §V-A), as in the JAX package: nothing on the device
allocates by it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

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


# --- presets (paper Table II, DGX figures from the paper's §VI-C sources),
# as the JAX package states them
SN40L_NODE = MachineTiers(
    name="sn40l",
    sram=MemoryTier("sram", int(0.52 * GiB), 400e12),
    hbm=MemoryTier("hbm", 64 * GiB, 1.8e12),
    capacity=MemoryTier("ddr", int(1.5 * 1024) * GiB, 200 * GBps),
    copy_bw_node=1e12,             # >1 TB/s aggregate DDR->HBM (paper §VI-C)
    sockets_per_node=8,
    peak_flops_bf16=638e12,
    hbm_efficiency=0.85,           # paper §VI-B
)

DGX_A100 = MachineTiers(
    name="dgx-a100",
    sram=MemoryTier("sram", int(0.04 * GiB), 200e12),
    hbm=MemoryTier("hbm", 80 * GiB, 2.0e12),
    capacity=MemoryTier("host", 2048 * GiB, 200 * GBps),
    copy_bw_node=32 * GBps,        # host->GPU PCIe (paper: 32 GB/s)
    sockets_per_node=8,
    peak_flops_bf16=312e12,
    hbm_efficiency=0.45,           # paper §VI-B: "rarely exceed 50%"
)

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

TPU_V5E_NODE = MachineTiers(
    name="tpu-v5e",
    sram=MemoryTier("vmem", 128 * 1024 ** 2, 400e12),
    hbm=MemoryTier("hbm", 16 * GiB, 819 * GBps),
    capacity=MemoryTier("host", 512 * GiB, 200 * GBps),
    copy_bw_node=8 * 32 * GBps,    # 8 chips/host x PCIe-class DMA
    sockets_per_node=8,
    peak_flops_bf16=197e12,
    hbm_efficiency=0.8,
)

MACHINES = {m.name: m for m in (SN40L_NODE, DGX_A100, DGX_H100, TPU_V5E_NODE)}


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


# ----------------------------------------------------------------------
# Static lifetime allocator (paper §V-A)
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Symbol:
    name: str
    size: int              # bytes
    first_use: int         # step index
    last_use: int          # inclusive
    read_only: bool = False
    transfer_footprint: int = 0   # aggregate bytes moved if spilled (reuse x size)


@dataclass
class Allocation:
    offsets: Dict[str, int]
    peak: int


def allocate_static(symbols: Sequence[Symbol], align: int = 512) -> Allocation:
    """Greedy lifetime-based allocation: symbols with disjoint [first, last]
    lifetimes may share addresses (the paper's 'static garbage
    collection'). Symbols are placed by (first_use, -size); a symbol is
    retired once its last_use is before the next first_use; the freed
    holes are coalesced and the smallest that fits is taken (its remainder
    stays a hole); only a miss grows the top. Sizes round up to ``align``."""
    def rnd(x):
        return (x + align - 1) // align * align

    events = sorted(symbols, key=lambda s: (s.first_use, -s.size))
    live: Dict[str, Tuple[int, int, int]] = {}   # name -> (off, size, last)
    holes: List[Tuple[int, int]] = []            # (offset, size)
    offsets: Dict[str, int] = {}
    peak = top = 0
    for sym in events:
        for n, (off, sz, last) in list(live.items()):
            if last < sym.first_use:
                holes.append((off, sz))
                del live[n]
        holes.sort()
        merged: List[Tuple[int, int]] = []
        for off, sz in holes:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        holes = merged
        need = rnd(sym.size)
        best = None
        for i, (off, sz) in enumerate(holes):
            if sz >= need and (best is None or sz < holes[best][1]):
                best = i
        if best is not None:
            off, sz = holes.pop(best)
            offsets[sym.name] = off
            if sz > need:
                holes.append((off + need, sz - need))
        else:
            offsets[sym.name] = top
            top += need
        live[sym.name] = (offsets[sym.name], need, sym.last_use)
        peak = max(peak, top)
    return Allocation(offsets, peak)


def spill_order(symbols: Sequence[Symbol]) -> List[Symbol]:
    """Spill candidates by aggregate transfer footprint ascending, then
    size: the symbols that would cost the least capacity-tier bandwidth go
    first, and weights (high reuse during decode) sort last."""
    return sorted(symbols, key=lambda s: (s.transfer_footprint, s.size))


def plan_placement(symbols: Sequence[Symbol], hbm_capacity: int,
                   align: int = 512) -> Tuple[Allocation, List[str]]:
    """Allocate into HBM; spill by ``spill_order`` of ``symbols`` until the
    peak fits. Returns (allocation of the resident symbols, spilled
    names in spill order)."""
    resident = list(symbols)
    spilled: List[str] = []
    order = spill_order(symbols)
    while True:
        alloc = allocate_static(resident, align)
        if alloc.peak <= hbm_capacity or not resident:
            return alloc, spilled
        victim = order[len(spilled)].name
        resident = [s for s in resident if s.name != victim]
        spilled.append(victim)
