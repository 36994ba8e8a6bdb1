"""Config registry of the port: ``get_config(arch_id)``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma_9b
from repro_torch.configs.samba_coe_expert import CONFIG as _samba_coe_expert

CONFIGS = {"samba-coe-expert-7b": _samba_coe_expert,
           "recurrentgemma-9b": _recurrentgemma_9b}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-").lower()
    if key not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(CONFIGS)} "
                       "(see ROADMAP.md for the families still to port)")
    return CONFIGS[key]


__all__ = ["ModelConfig", "reduced", "CONFIGS", "get_config"]
