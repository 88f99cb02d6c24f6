from repro_torch.optim.schedules import constant, cosine, warmup_cosine
from repro_torch.optim.sgd import (adamw_init, adamw_update,
                                   clip_by_global_norm, global_norm,
                                   make_optimizer, momentum_init,
                                   momentum_update, sgd_update,
                                   sgd_update_)

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "constant",
           "cosine", "global_norm", "make_optimizer", "momentum_init",
           "momentum_update", "sgd_update", "sgd_update_", "warmup_cosine"]
