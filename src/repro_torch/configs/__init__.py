"""Config registry of the port: ``get_config(arch_id)``."""
from __future__ import annotations

from repro_torch.configs.base import (SHAPE_CELLS, ModelConfig, ShapeCell,
                                      cell_applicable, pad_for_tp, reduced)
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3_6b
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.granite_8b import CONFIG as _granite_8b
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen2_5_32b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl_2b
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma_9b
from repro_torch.configs.samba_coe_expert import CONFIG as _samba_coe_expert
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2_3b
from repro_torch.configs.whisper_small import CONFIG as _whisper_small
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm_1_3b

CONFIGS = {c.name: c for c in (_samba_coe_expert, _granite_8b, _qwen2_5_32b,
                               _chatglm3_6b, _starcoder2_3b, _qwen2_vl_2b,
                               _mixtral_8x7b, _deepseek, _recurrentgemma_9b,
                               _whisper_small, _xlstm_1_3b)}

# the dry-run's archs, in JAX's order: every config but the paper's expert
ARCH_IDS = ("qwen2-vl-2b", "whisper-small", "deepseek-v2-lite-16b",
            "mixtral-8x7b", "starcoder2-3b", "qwen2.5-32b", "granite-8b",
            "chatglm3-6b", "recurrentgemma-9b", "xlstm-1.3b")


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-").lower()
    if key not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(CONFIGS)}")
    return CONFIGS[key]


__all__ = ["ModelConfig", "ShapeCell", "SHAPE_CELLS", "cell_applicable",
           "pad_for_tp", "reduced", "CONFIGS", "ARCH_IDS", "get_config"]
