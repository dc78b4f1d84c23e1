"""The :class:`TrainProgram` protocol — the contract between a runtime and
the :class:`~repro_torch.train.loop.TrainLoop` (the port of
``repro/train/program.py``).

A program owns the step functions and the runtime's state layout; the loop
owns the step loop, eval cadence, throughput and comm-bytes accounting and
the JSONL telemetry.  Batches arrive stacked: numpy ``{tokens, labels}`` of
shape ``(replicas, per_replica_batch, seq)`` from :func:`repro_torch.data.
shard_iterator`.  The JAX package's loss draws nothing from its PRNG keys,
so the port's steps take none.  ``state_pytree`` / ``load_state_pytree``
give the checkpoint view of the state in the JAX package's layout, so a
checkpoint of either package resumes in the other.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from repro_torch.comm.bytes_model import CommCost

__all__ = ["TrainProgram"]


@runtime_checkable
class TrainProgram(Protocol):
    """What a runtime must provide to be driven by :class:`TrainLoop`."""

    #: number of gossip replicas (the leading axis of stacked batches)
    replicas: int

    def init_state(self, example_batch: dict) -> Any:
        """Build the initial training state (the batch gives shapes only)."""
        ...

    def inner_step(self, state: Any, batch: dict) -> tuple[Any, dict]:
        """One local optimizer step on every replica; returns (state,
        metrics) with per-replica losses in ``metrics["loss"]``."""
        ...

    def maybe_outer_step(self, state: Any) -> tuple[Any, bool]:
        """Run the outer step iff due; returns (state, synced)."""
        ...

    def eval_step(self, state: Any, batch: dict) -> float:
        """Grad-free mean eval loss across replicas for one stacked batch."""
        ...

    def weight_std(self, state: Any) -> float:
        """Cross-replica weight std (paper Fig. 3B / Fig. 4A diagnostic)."""
        ...

    def state_pytree(self, state: Any) -> Any:
        """The state as a tree of host arrays for a checkpoint."""
        ...

    def load_state_pytree(self, state: Any, tree: Any) -> Any:
        """The state restored from a checkpoint tree; ``state`` is a freshly
        initialised state of the same run."""
        ...

    def comm_cost(self) -> CommCost | None:
        """Static per-replica cost of one outer step, or None when the
        runtime never communicates."""
        ...
