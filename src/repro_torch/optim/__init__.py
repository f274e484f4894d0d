from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm, sgd)
from repro_torch.optim.schedules import (constant_schedule, cosine_schedule,
                                         warmup_cosine)

__all__ = ["Optimizer", "sgd", "adamw", "apply_updates",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "warmup_cosine"]
