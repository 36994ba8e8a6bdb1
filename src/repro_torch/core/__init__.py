from repro_torch.core.coe import CompositionOfExperts, ExpertHandle
from repro_torch.core.memory_tiers import (DGX_H100, HBMBudget, MachineTiers,
                                           plan_hbm_budget)
from repro_torch.core.router import HashRouter
from repro_torch.core.switching import HBMWeightCache, model_switch_time

__all__ = ["CompositionOfExperts", "ExpertHandle", "DGX_H100", "HBMBudget",
           "MachineTiers", "plan_hbm_budget", "HashRouter", "HBMWeightCache",
           "model_switch_time"]
