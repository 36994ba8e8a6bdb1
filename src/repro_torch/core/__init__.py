from repro_torch.core.coe import (CompositionOfExperts, ExpertHandle,
                                  GenerationResult)
from repro_torch.core.memory_tiers import (DGX_H100, MACHINES, Allocation,
                                           HBMBudget, MachineTiers, Symbol,
                                           allocate_static, plan_hbm_budget,
                                           plan_placement, spill_order)
from repro_torch.core.router import HashRouter, LMRouter
from repro_torch.core.switching import HBMWeightCache, model_switch_time

__all__ = ["CompositionOfExperts", "ExpertHandle", "GenerationResult",
           "DGX_H100", "MACHINES", "HBMBudget", "MachineTiers", "plan_hbm_budget",
           "Symbol", "Allocation", "allocate_static", "spill_order",
           "plan_placement",
           "HashRouter", "LMRouter", "HBMWeightCache", "model_switch_time"]
