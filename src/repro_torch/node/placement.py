"""Expert -> socket-group placement under per-group HBM budgets (a copy of
``repro.node.placement``; the default machine is ``DGX_H100``).

CoServe (arXiv 2503.02354) shows expert placement under limited memory
dominates CoE throughput; "AI and Memory Wall" (arXiv 2403.14123) argues
bandwidth, not FLOPs, should drive it. This planner follows both:

  * each expert's cost is ``bandwidth_model.expert_service_cost`` — the
    memory-bound decode step model at the group's TP degree, plus the
    DDR->HBM copy per activation when the expert cannot stay resident;
  * experts are assigned greedily, hottest first, to the least-loaded group
    whose remaining *weights* budget (``HBMBudget.weights_bytes``) still
    fits them — the planned-resident set per group can never exceed its HBM
    share by construction;
  * hot experts (demand share >= ``replicate_share``) are replicated across
    several groups so one group is never the bottleneck;
  * experts that fit in no group's remaining HBM spill: they still get an
    owning group (dispatch target) but stream from the shared ``ExpertStore``
    on every activation, and their cost is charged accordingly.

The plan is pure data in / data out — the node scheduler recomputes it
online from observed demand (``RDUNode.rebalance``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.bandwidth_model import expert_service_cost
from repro_torch.core.memory_tiers import DGX_H100, MachineTiers


@dataclass(frozen=True)
class ExpertProfile:
    """What the planner knows about one expert ahead of time: its AOT size
    contract and its (observed or forecast) demand weight."""
    name: str
    nbytes: int
    demand: float = 1.0


@dataclass(frozen=True)
class Placement:
    assignment: Dict[str, Tuple[int, ...]]   # expert -> owning group ids
    resident: Dict[int, Tuple[str, ...]]     # group -> planned-resident set
    spilled: Tuple[str, ...]                 # stream-from-store experts
    loads: Dict[int, float]                  # planned service seconds / group

    def owners(self, name: str) -> Tuple[int, ...]:
        return self.assignment.get(name, ())

    def resident_bytes(self, gid: int,
                       sizes: Mapping[str, int]) -> int:
        return sum(sizes[n] for n in self.resident.get(gid, ()))


def plan_expert_placement(profiles: Sequence[ExpertProfile],
                          group_weight_budgets: Sequence[int], *,
                          machine: MachineTiers = DGX_H100,
                          tp: int = 1, avg_tokens: int = 16,
                          replicate_share: float = 0.5) -> Placement:
    """Greedy bandwidth-balanced assignment of experts to socket groups.

    ``group_weight_budgets[g]`` is group g's HBM weights share in bytes
    (``coe.hbm_budget.weights_bytes``). Returns a :class:`Placement` whose
    per-group resident bytes never exceed the budgets.
    """
    n_groups = len(group_weight_budgets)
    if n_groups < 1:
        raise ValueError("need at least one socket group")
    total = sum(max(p.demand, 0.0) for p in profiles)
    if total <= 0:                       # no signal yet: plan uniform demand
        profiles = [ExpertProfile(p.name, p.nbytes, 1.0) for p in profiles]
        total = float(len(profiles))

    budgets = [int(b) for b in group_weight_budgets]
    loads = {g: 0.0 for g in range(n_groups)}
    assignment: Dict[str, Tuple[int, ...]] = {}
    resident: Dict[int, List[str]] = {g: [] for g in range(n_groups)}
    spilled: List[str] = []

    def cost(p: ExpertProfile, share_of_demand: float, is_resident: bool):
        return expert_service_cost(
            p.nbytes, p.demand * share_of_demand, machine, tp=tp,
            avg_tokens=avg_tokens, resident=is_resident)

    order = sorted(profiles,
                   key=lambda p: (cost(p, 1.0, True), p.nbytes),
                   reverse=True)
    for p in order:
        share = max(p.demand, 0.0) / total
        replicas = min(n_groups, max(1, math.ceil(share / replicate_share)))
        owners: List[int] = []
        for _ in range(replicas):
            candidates = sorted((g for g in range(n_groups)
                                 if g not in owners),
                                key=lambda g: loads[g])
            fit = next((g for g in candidates if budgets[g] >= p.nbytes),
                       None)
            if fit is None:
                break
            owners.append(fit)
            budgets[fit] -= p.nbytes
            resident[fit].append(p.name)
        if owners:
            per_owner = cost(p, 1.0 / len(owners), True)
            for g in owners:
                loads[g] += per_owner
        else:
            # fits nowhere: stream from the shared store via the least
            # loaded group; every activation pays the DDR->HBM copy
            g = min(range(n_groups), key=lambda g: loads[g])
            owners = [g]
            loads[g] += cost(p, 1.0, False)
            spilled.append(p.name)
        assignment[p.name] = tuple(owners)

    return Placement(assignment=assignment,
                     resident={g: tuple(v) for g, v in resident.items()},
                     spilled=tuple(spilled),
                     loads=loads)
