"""Training engine of the port: one loop driving the stacked-simulation,
replica-group and routed-pipeline programs (``repro/train`` in the JAX
package)."""

from repro_torch.train.adapters import DistributedProgram, GossipProgram, PipelineProgram
from repro_torch.train.loop import LoopConfig, TrainLoop, make_loop
from repro_torch.train.program import TrainProgram

__all__ = ["DistributedProgram", "GossipProgram", "LoopConfig", "PipelineProgram", "TrainLoop", "TrainProgram", "make_loop"]
