from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import Schedule, constant, linear_warmup, warmup_cosine

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "global_norm", "Schedule", "constant", "linear_warmup", "warmup_cosine",
]
