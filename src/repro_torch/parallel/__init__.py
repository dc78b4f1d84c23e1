"""The multi-GPU runtime's plans and step builders (``repro/parallel`` in
the JAX package), over ``torch.distributed``: one rank per replica."""

from repro_torch.parallel import plans, steps
from repro_torch.parallel.plans import Plan, make_plan

__all__ = ["Plan", "make_plan", "plans", "steps"]
