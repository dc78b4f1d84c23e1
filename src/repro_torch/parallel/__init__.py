"""The multi-GPU runtime's plans, model-axis context and step builders
(``repro/parallel`` in the JAX package), over ``torch.distributed``.
``parallel.steps`` imports the model code, which imports
``parallel.sharding``: import it as a submodule
(``from repro_torch.parallel import steps``)."""

from repro_torch.parallel import plans, sharding
from repro_torch.parallel.plans import Plan, make_plan
from repro_torch.parallel.sharding import ShardCtx

__all__ = ["Plan", "make_plan", "ShardCtx", "plans", "sharding"]
