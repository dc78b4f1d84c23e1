"""NoLoCo core of the port: pairing, the outer optimizers (streamed too),
the stacked trainer, and the Appendix A theory and §5.3 latency models."""

from repro_torch.core import metrics, pairing
from repro_torch.core.noloco import GossipTrainer, TrainerConfig, TrainState
from repro_torch.core.outer import (
    OuterConfig,
    OuterState,
    StreamSchedule,
    default_gamma,
    gamma_band,
    init_outer_state,
    outer_gradient,
    outer_step,
    outer_step_stacked,
    outer_step_stacked_stream,
)
from repro_torch.core.pairing import Membership
from repro_torch.core import latency, theory

__all__ = [
    "GossipTrainer", "Membership", "OuterConfig", "OuterState", "StreamSchedule", "TrainState",
    "TrainerConfig", "default_gamma", "gamma_band", "init_outer_state", "metrics",
    "latency", "outer_gradient", "outer_step", "outer_step_stacked", "outer_step_stacked_stream",
    "pairing", "theory",
]
