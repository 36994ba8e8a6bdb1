"""Static bandwidth/latency model (a copy of ``repro.core.bandwidth_model``;
paper §VII 'Managing bandwidth in software': a first-order static model of
application needs against hardware).

``node/placement.py`` balances socket groups on ``expert_service_cost``; the
other functions are the Fig 12 / Fig 13 projections. Every constant comes
from a ``MachineTiers`` preset: published figures, not measurements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.core.memory_tiers import MachineTiers


@dataclass(frozen=True)
class StepCost:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)


def decode_step_cost(n_active_params: int, kv_bytes_per_token_ctx: int,
                     batch: int, machine: MachineTiers, tp: int = 8,
                     dtype_bytes: int = 2,
                     collective_bytes: float = 0.0,
                     link_bw: float = 50e9) -> StepCost:
    """One autoregressive decode step for a whole batch, TP over `tp` sockets.

    memory term: every active weight byte + the KV cache bytes stream from
    HBM once per step (the paper's >85%-of-HBM-bw fused decode regime).
    """
    weight_bytes = n_active_params * dtype_bytes
    flops = 2.0 * n_active_params * batch
    mem = (weight_bytes + kv_bytes_per_token_ctx * batch) / tp
    comp = flops / tp
    coll = collective_bytes / tp
    return StepCost(
        compute_s=comp / machine.peak_flops_bf16,
        memory_s=mem / (machine.hbm.bandwidth * machine.hbm_efficiency),
        collective_s=coll / link_bw,
    )


def switch_cost(expert_bytes: int, machine: MachineTiers) -> float:
    """Capacity tier -> HBM copy time (whole node bandwidth)."""
    return expert_bytes / machine.copy_bw_node


def expert_service_cost(expert_bytes: int, requests: float,
                        machine: MachineTiers, *, tp: int = 1,
                        avg_tokens: int = 16, resident: bool = True,
                        dtype_bytes: int = 2) -> float:
    """First-order seconds to serve ``requests`` requests of one expert on a
    ``tp``-socket group: decode execution (memory-bound step model) plus, for
    a non-resident expert, one capacity-tier -> HBM copy per activation.
    ``node/placement.py`` balances socket groups on this cost — per-socket
    *bandwidth*, not FLOPs, drives the assignment (arXiv 2403.14123)."""
    n_params = max(expert_bytes // dtype_bytes, 1)
    step = decode_step_cost(n_params, 0, 1, machine, tp=tp).step_s
    exec_s = requests * avg_tokens * step
    miss_s = 0.0 if resident else requests * switch_cost(expert_bytes, machine)
    return exec_s + miss_s


def coe_latency(n_experts_used: int, expert_bytes: int, resident_experts: int,
                decode_cost: StepCost, n_tokens: int, machine: MachineTiers,
                router_cost_s: float = 0.0) -> Dict[str, float]:
    """Fig 12 model: total latency to serve one batch where
    ``n_experts_used`` distinct experts are needed and ``resident_experts``
    already sit in HBM (LRU hits)."""
    misses = max(0, n_experts_used - resident_experts)
    sw = misses * switch_cost(expert_bytes, machine)
    ex = n_experts_used * n_tokens * decode_cost.step_s
    return {"switch_s": sw, "exec_s": ex, "router_s": router_cost_s,
            "total_s": sw + ex + router_cost_s}


def footprint_nodes(n_experts: int, expert_bytes: int, machine: MachineTiers,
                    use_capacity_tier: bool) -> int:
    """Fig 13 model: nodes needed to *hold* a CoE at full service latency.
    With the capacity tier, experts live in DDR/host and stream to HBM; the
    HBM only needs the working set. Without it (the DGX HBM-only scenario),
    all experts must fit in aggregate HBM."""
    total = n_experts * expert_bytes
    if use_capacity_tier:
        # capacity tier is per socket (paper Table II: 1.5 TiB DDR / socket)
        per_node = machine.capacity.capacity * machine.sockets_per_node
    else:
        # HBM-only: reserve ~8% for KV cache + activations
        per_node = machine.hbm.capacity * machine.sockets_per_node * 0.92
    return max(1, math.ceil(total / per_node))
