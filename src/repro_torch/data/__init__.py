from repro_torch.data.pipeline import (DataConfig, MemmapTokens, SyntheticLM,
                                       iterate, make_source)

__all__ = ["DataConfig", "SyntheticLM", "MemmapTokens", "make_source",
           "iterate"]
