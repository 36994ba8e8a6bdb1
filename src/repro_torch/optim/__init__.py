from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, lr_schedule)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_schedule",
           "global_norm"]
