from repro_torch.models.common import (ParamSpec, abstract_params,
                                       init_params, param_bytes, param_count,
                                       spec)
from repro_torch.models.registry import Model, get_model

__all__ = ["Model", "get_model", "ParamSpec", "spec", "abstract_params",
           "init_params", "param_count", "param_bytes"]
