from repro_torch.core.coe import (CompositionOfExperts, ExpertHandle,
                                  GenerationResult)
from repro_torch.core.memory_tiers import (DGX_H100, HBMBudget, MachineTiers,
                                           plan_hbm_budget)
from repro_torch.core.router import HashRouter, LMRouter
from repro_torch.core.switching import HBMWeightCache, model_switch_time

__all__ = ["CompositionOfExperts", "ExpertHandle", "GenerationResult",
           "DGX_H100", "HBMBudget", "MachineTiers", "plan_hbm_budget",
           "HashRouter", "LMRouter", "HBMWeightCache", "model_switch_time"]
