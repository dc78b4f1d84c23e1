"""Deterministic fault injection for the stacked simulation (the port of
``repro/sim``): a :class:`FaultPlan` of drops, warm-started rejoins,
stragglers, rate changes, partitions and heals, replayed by
:class:`SimCluster` against the real training program."""

from repro_torch.sim.faults import FaultEvent, FaultPlan
from repro_torch.sim.cluster import ReplicaClock, SimCluster

__all__ = ["FaultEvent", "FaultPlan", "ReplicaClock", "SimCluster"]
