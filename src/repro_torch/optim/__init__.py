from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.schedules import Schedule, warmup_cosine

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm", "Schedule",
    "warmup_cosine",
]
