from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "global_norm",
           "warmup_cosine", "constant"]
