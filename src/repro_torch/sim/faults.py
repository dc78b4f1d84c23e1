"""Fault plans: the declarative schedule of cluster events a SimCluster
replays against a real training program (the port of
``repro/sim/faults.py``; plain Python, no tensors).

A plan is a list of :class:`FaultEvent`\\ s, each anchored either to an inner
``step`` or to an outer ``round`` (``round: r`` resolves to the first inner
step of round *r*'s inner phase, ``r * m`` — the event is in force for that
round's exchange).  Plans are plain JSON on the wire::

    {"events": [
        {"kind": "drop",    "round": 2, "replicas": [3, 5]},
        {"kind": "rejoin",  "round": 5, "replicas": [3, 5]},
        {"kind": "straggle","round": 3, "replicas": [1], "rounds": 1},
        {"kind": "rate",    "step": 0, "replicas": [1], "rate": 0.5},
        {"kind": "partition","round": 4, "groups": [[0, 1, 2, 3], [4, 5, 6, 7]]},
        {"kind": "heal",    "round": 6}
    ]}

Event kinds:

``drop``
    Replicas leave the cluster: frozen in inner AND outer steps, excluded
    from every pairing draw (membership epoch bumps).
``rejoin``
    Replicas come back, warm-started from a live peer's slow weights φ
    (``source``, default: lowest-id active replica): θ = φ = φ_source,
    δ = 0, fresh inner-optimizer moments.  Membership epoch bumps.
``straggle``
    Replicas miss the next ``rounds`` outer rounds (participation, not
    membership): their partners self-pair, their own (φ, δ, θ-reset) are
    skipped, inner training continues — the next round they join sees a
    Δ spanning the missed rounds' inner steps.
``rate``
    Replicas change wall-clock speed: from the anchor step on, the replica
    earns inner steps at ``rate`` times the full tick rate (``rate: 1.0``
    restores full speed).  Unlike ``straggle`` — a one-shot participation
    debt measured in whole rounds — a rate multiplier puts the replica on
    its OWN round clock: it reaches each sync index late and exchanges a
    stale Δ instead of sitting the round out (SimCluster's asynchronous
    clock, DESIGN.md §7).  Rates persist until changed by a later event.
``partition``
    The pairing graph splits into ``groups``: pairs never cross a component
    until a ``heal`` event (gossip keeps running inside each island).
``heal``
    Remove the partition.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable

__all__ = ["FaultEvent", "FaultPlan", "KINDS"]

KINDS = ("drop", "rejoin", "straggle", "rate", "partition", "heal")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    replicas: tuple[int, ...] = ()
    step: int | None = None     # inner step the event applies before
    round: int | None = None    # outer round whose inner phase it opens
    rounds: int = 1             # straggle: consecutive outer rounds missed
    rate: float = 1.0           # rate: step-rate multiplier (0 < rate <= 1)
    source: int | None = None   # rejoin: peer whose φ seeds the warm start
    groups: tuple[tuple[int, ...], ...] = ()  # partition components

    def __post_init__(self):
        object.__setattr__(self, "replicas", tuple(int(r) for r in self.replicas))
        object.__setattr__(
            self, "groups", tuple(tuple(int(r) for r in g) for g in self.groups)
        )

    def resolved_step(self, inner_steps: int) -> int:
        """The inner step this event applies BEFORE."""
        if self.step is not None:
            return int(self.step)
        return int(self.round) * int(inner_steps)

    def effect_end_step(self, inner_steps: int) -> int:
        """The last inner step this event still has an effect at.

        For most kinds that is the anchor step itself, but a ``straggle``
        debt stays in force for ``rounds`` further outer rounds — a run whose
        horizon truncates the debt must checkpoint it and resume exactly
        (the SimCluster persists in-flight debts in its state pytree).  A
        ``rate`` multiplier persists until a later rate event, so its effect
        is open-ended and launchers should not warn about it."""
        anchor = self.resolved_step(inner_steps)
        if self.kind == "straggle":
            return anchor + int(self.rounds) * int(inner_steps)
        return anchor

    def validate(self, world: int) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind: {self.kind!r} (one of {KINDS})")
        if (self.step is None) == (self.round is None):
            raise ValueError(
                f"{self.kind} event needs exactly one of step/round "
                f"(got step={self.step}, round={self.round})"
            )
        anchor = self.step if self.step is not None else self.round
        if anchor < 0:
            raise ValueError(f"{self.kind} event anchored at negative {anchor}")
        if self.kind in ("drop", "rejoin", "straggle", "rate") and not self.replicas:
            raise ValueError(f"{self.kind} event needs replicas")
        for r in self.replicas:
            if not 0 <= r < world:
                raise ValueError(f"replica id {r} outside world {world}")
        if self.kind == "straggle" and self.rounds < 1:
            raise ValueError("straggle needs rounds >= 1")
        if self.kind == "rate" and not 0.0 < self.rate <= 1.0:
            raise ValueError(
                f"rate event needs 0 < rate <= 1 (rates are relative to the "
                f"fastest replica's tick rate; got {self.rate})"
            )
        if self.kind == "partition":
            if not self.groups:
                raise ValueError("partition event needs groups")
            flat = [r for g in self.groups for r in g]
            if len(flat) != len(set(flat)):
                raise ValueError("partition groups must be disjoint")
            for r in flat:
                if not 0 <= r < world:
                    raise ValueError(f"partition replica id {r} outside world {world}")
        if self.source is not None and not 0 <= self.source < world:
            raise ValueError(f"source id {self.source} outside world {world}")

    def as_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"kind": self.kind}
        if self.step is not None:
            out["step"] = self.step
        if self.round is not None:
            out["round"] = self.round
        if self.replicas:
            out["replicas"] = list(self.replicas)
        if self.kind == "straggle":
            out["rounds"] = self.rounds
        if self.kind == "rate":
            out["rate"] = self.rate
        if self.source is not None:
            out["source"] = self.source
        if self.groups:
            out["groups"] = [list(g) for g in self.groups]
        return out

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultEvent":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown fault event fields: {sorted(extra)}")
        d = dict(d)
        return cls(
            kind=d.pop("kind"),
            replicas=tuple(d.pop("replicas", ())),
            groups=tuple(tuple(g) for g in d.pop("groups", ())),
            **d,
        )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered schedule of fault events (order breaks same-step ties)."""

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def validate(self, world: int) -> None:
        for ev in self.events:
            ev.validate(world)

    def events_at(self, step: int, inner_steps: int) -> list[FaultEvent]:
        return [
            ev for ev in self.events if ev.resolved_step(inner_steps) == step
        ]

    def max_anchor_step(self, inner_steps: int) -> int:
        """The last inner step any event applies before (-1 for an empty
        plan).  Launchers compare this against the run horizon: an event
        anchored past ``--steps`` silently never fires, which is almost
        always a misconfigured plan worth warning about."""
        if not self.events:
            return -1
        return max(ev.resolved_step(inner_steps) for ev in self.events)

    def max_effect_step(self, inner_steps: int) -> int:
        """The last inner step any event still has an effect at (-1 for an
        empty plan).  Straggle debts extend ``rounds`` outer rounds past
        their anchor, so this can exceed :meth:`max_anchor_step` — launchers
        warn against THIS when a plan's effects outlive ``--steps`` (the
        in-flight part checkpoints and resumes exactly; the warning is for
        the case where the run is never resumed).  Open-ended ``rate``
        events are excluded: a persistent rate is not a truncation."""
        if not self.events:
            return -1
        return max(
            ev.effect_end_step(inner_steps)
            for ev in self.events
        )

    def rate_events(self) -> list[FaultEvent]:
        """The rate events in the plan (SimCluster auto-enables its
        asynchronous per-replica clock when any are present)."""
        return [ev for ev in self.events if ev.kind == "rate"]

    def to_json(self) -> str:
        return json.dumps({"events": [ev.as_dict() for ev in self.events]}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        events = data["events"] if isinstance(data, dict) else data
        return cls(events=tuple(FaultEvent.from_dict(d) for d in events))

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def build(cls, events: Iterable[FaultEvent | dict]) -> "FaultPlan":
        return cls(events=tuple(
            ev if isinstance(ev, FaultEvent) else FaultEvent.from_dict(ev)
            for ev in events
        ))
