"""NoLoCo core of the port: pairing, the outer optimizers and the stacked
trainer."""

from repro_torch.core import metrics, pairing
from repro_torch.core.noloco import GossipTrainer, TrainerConfig, TrainState
from repro_torch.core.outer import (
    OuterConfig,
    OuterState,
    default_gamma,
    gamma_band,
    init_outer_state,
    outer_gradient,
    outer_step,
    outer_step_stacked,
)
from repro_torch.core.pairing import Membership

__all__ = [
    "GossipTrainer", "Membership", "OuterConfig", "OuterState", "TrainState", "TrainerConfig",
    "default_gamma", "gamma_band", "init_outer_state", "metrics", "outer_gradient",
    "outer_step", "outer_step_stacked", "pairing",
]
