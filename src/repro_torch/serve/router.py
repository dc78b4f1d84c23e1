"""Multi-replica request routing (the port of ``repro/serve/router.py``).

A NoLoCo checkpoint promotes to several serving models, one per ensemble
replica, and nothing forces them behind one engine: each replica gets its
own :class:`~repro_torch.serve.engine.ServeEngine` (its own page pool and
slots, on any device) and the router spreads requests across them.

Policies:
  * ``round_robin`` — requests cycle through the replicas in submission
    order; deterministic, good when replicas and requests are uniform.
  * ``least_loaded`` — each request goes to the replica with the fewest
    queued and in-flight tokens of pending work; absorbs skewed request
    sizes.

Routing keeps every request's tokens: engines share no mutable state, and
a request's tokens depend only on (params, request id, prompt), not on
which replica decodes it when the replicas serve the same weights.  With
different replicas each request gets the tokens of the one it lands on.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.serve.engine import FinishedRequest, Request, ServeEngine

__all__ = ["ReplicaRouter"]


class ReplicaRouter:
    """Fan requests out over a pool of promoted ServeEngines."""

    def __init__(self, engines: Sequence[ServeEngine], policy: str = "least_loaded"):
        if not engines:
            raise ValueError("router needs at least one engine")
        if policy not in ("round_robin", "least_loaded"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.engines = list(engines)
        self.policy = policy
        self._rr = 0
        self.routed: list[int] = [0] * len(self.engines)

    def _load(self, eng: ServeEngine) -> int:
        """Pending work in tokens: queued prompts and budgets plus the
        remaining prompt and budget of every occupied slot."""
        load = sum(len(r.prompt) + r.max_new for r in eng.queue)
        for occ in eng._slots:
            if occ is None:
                continue
            req = occ["req"]
            left = len(req.prompt) - occ.get("cursor", len(req.prompt))
            load += left + max(req.max_new - occ["steps"], 0)
        return load

    def pick(self) -> int:
        if self.policy == "round_robin":
            i = self._rr % len(self.engines)
            self._rr += 1
            return i
        loads = [self._load(e) for e in self.engines]
        return loads.index(min(loads))

    def submit(self, req: Request) -> int:
        """Route one request; returns the replica index it landed on."""
        i = self.pick()
        self.engines[i].submit(req)
        self.routed[i] += 1
        return i

    @property
    def idle(self) -> bool:
        return all(e.idle for e in self.engines)

    def step(self) -> list[tuple[int, FinishedRequest]]:
        """One tick of every busy engine; returns (replica, finished) pairs."""
        done: list[tuple[int, FinishedRequest]] = []
        for i, eng in enumerate(self.engines):
            if not eng.idle:
                done.extend((i, f) for f in eng.step())
        return done

    def run(self, requests: Sequence[Request]) -> list[tuple[int, FinishedRequest]]:
        """Route and serve a request batch to completion."""
        for r in requests:
            self.submit(r)
        finished: list[tuple[int, FinishedRequest]] = []
        guard = 0
        limit = 10_000 + sum(len(r.prompt) + r.max_new for r in requests) * 4
        while not self.idle:
            finished.extend(self.step())
            guard += 1
            if guard > limit:  # pragma: no cover
                raise RuntimeError("router loop failed to converge")
        for i, eng in enumerate(self.engines):
            finished.extend((i, f) for f in eng._evict_finished())
        return finished
