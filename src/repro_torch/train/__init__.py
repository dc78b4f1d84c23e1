"""Training engine of the port: one loop driving the stacked-simulation
program (``repro/train`` in the JAX package)."""

from repro_torch.train.adapters import GossipProgram
from repro_torch.train.loop import LoopConfig, TrainLoop, make_loop
from repro_torch.train.program import TrainProgram

__all__ = ["GossipProgram", "LoopConfig", "TrainLoop", "TrainProgram", "make_loop"]
