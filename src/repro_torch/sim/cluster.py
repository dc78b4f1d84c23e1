"""SimCluster: drive the real training program through cluster churn (the
port of ``repro/sim/cluster.py``).

The simulator is a :class:`~repro_torch.train.program.TrainProgram`
decorator: the :class:`~repro_torch.train.loop.TrainLoop` drives it like a
healthy program, and every inner and outer step below it is the
production path (on the card: the flash pair every inner step, the NoLoCo
update kernel every round).  It does four things:

  * replays the :class:`~repro_torch.sim.faults.FaultPlan` at inner-step
    boundaries (drops, rejoins, stragglers, rate changes, partitions),
    each event once, keyed by the state's own step counter, so a resumed
    run never applies an event twice;
  * delegates the rejoin warm start to the program (θ = φ = a live peer's
    φ, δ = 0, fresh AdamW moments);
  * with ``reassign_data``, redistributes dropped replicas' loader streams
    over survivors (:func:`~repro_torch.core.elastic.stream_assignment`, a
    pure function of ``(membership, t)``), on the host before the batch
    reaches the device;
  * keeps an auditable ``history`` of events and per-round participation,
    partner tables included.

Asynchronous rounds: when the plan carries ``rate`` events (or
``async_clock=True``), each replica gets its own :class:`ReplicaClock`; a
slow replica reaches a sync index late and exchanges a stale Δ at the next
merged sync tick instead of sitting the round out.  The pairing at a merged
tick is drawn over all round participants (non-due ones are passive
sources), only due replicas update, and each contribution's staleness τ
feeds the ``stale="momentum"`` discount.  A rate-1 world is bit-identical
to the synchronous path.  The port's steps take no PRNG key, so
``inner_step`` takes ``(state, batch)``.

It wraps either runtime: the stacked :class:`~repro_torch.train.adapters.
GossipProgram` or a replica group's :class:`~repro_torch.train.adapters.
DistributedProgram`, where every rank runs its own ``SimCluster`` from the
same plan (the events, stragglers and clocks are host-side and
deterministic, so the ranks agree on every round with no message) and
only rank 0's checkpoint tree is written.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core import pairing as pairing_lib
from repro_torch.core.elastic import stream_assignment
from repro_torch.sim.faults import FaultEvent, FaultPlan

__all__ = ["ReplicaClock", "SimCluster"]


class ReplicaClock:
    """Per-replica round clocks: pure host-side state, fully checkpointable.

    Wall time is the TrainLoop's step counter (one tick per loop step).  Each
    replica earns inner steps at its ``rate`` (credits accumulate; a step is
    granted when credit reaches 1), so ``local_step`` counts the steps a
    replica ACTUALLY took.  Replica ``r`` is *due* for its next sync once
    ``local_step[r] >= (sync_count[r] + 1) * m`` — heterogeneous rates put
    replicas on different sync indices.  Whenever the due set is non-empty
    the cluster runs one MERGED sync tick (counter ``merged_tick``); a due
    replica's staleness τ is the number of merged ticks it skipped since its
    own previous sync — stationary at ``1/rate − 1`` for a constant-rate
    straggler, and exactly 0 everywhere in a rate-1 world.
    """

    def __init__(self, world: int, inner_steps: int):
        self.world = int(world)
        self.inner_steps = int(inner_steps)
        self.rate = np.ones((world,), dtype=np.float64)
        self.credit = np.zeros((world,), dtype=np.float64)
        self.local_step = np.zeros((world,), dtype=np.int64)
        self.sync_count = np.zeros((world,), dtype=np.int64)
        self.last_sync_tick = np.full((world,), -1, dtype=np.int64)
        self.merged_tick = 0

    def set_rate(self, replicas, rate: float) -> None:
        for r in replicas:
            self.rate[int(r)] = float(rate)

    def tick(self, member_mask: np.ndarray) -> np.ndarray:
        """Advance one wall tick; returns the bool step-grant mask.

        Non-members neither accrue credit nor step (their clock is paused —
        a rejoin resumes it without a backlog burst)."""
        member = np.asarray(member_mask, dtype=bool)
        self.credit = np.where(member, self.credit + self.rate, self.credit)
        # 1e-9 slack absorbs float accumulation drift for rates like 1/3
        grant = member & (self.credit >= 1.0 - 1e-9)
        self.credit = np.where(grant, self.credit - 1.0, self.credit)
        self.local_step = np.where(grant, self.local_step + 1, self.local_step)
        return grant

    def due_mask(self, member_mask: np.ndarray) -> np.ndarray:
        member = np.asarray(member_mask, dtype=bool)
        m = self.inner_steps
        return member & (self.local_step >= (self.sync_count + 1) * m)

    def staleness(self) -> np.ndarray:
        """τ per replica at the CURRENT merged tick: ticks skipped since the
        replica's own previous sync (0 for a replica that synced last tick,
        and 0 for everyone at the very first tick)."""
        return np.maximum(self.merged_tick - self.last_sync_tick - 1, 0)

    def advance_sync(self, due: np.ndarray) -> None:
        """Account one merged sync tick: ``due`` replicas' sync indices move."""
        due = np.asarray(due, dtype=bool)
        self.sync_count = np.where(due, self.sync_count + 1, self.sync_count)
        self.last_sync_tick = np.where(due, self.merged_tick, self.last_sync_tick)
        self.merged_tick += 1

    # -- checkpoint view ----------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "rate": self.rate.copy(),
            "credit": self.credit.copy(),
            "local_step": self.local_step.copy(),
            "sync_count": self.sync_count.copy(),
            "last_sync_tick": self.last_sync_tick.copy(),
            "merged_tick": np.int64(self.merged_tick),
        }

    def load_state_dict(self, tree: dict) -> None:
        self.rate = np.asarray(tree["rate"], dtype=np.float64).copy()
        self.credit = np.asarray(tree["credit"], dtype=np.float64).copy()
        self.local_step = np.asarray(tree["local_step"], dtype=np.int64).copy()
        self.sync_count = np.asarray(tree["sync_count"], dtype=np.int64).copy()
        self.last_sync_tick = np.asarray(
            tree["last_sync_tick"], dtype=np.int64
        ).copy()
        self.merged_tick = int(tree["merged_tick"])


class SimCluster:
    """Deterministic fault-injecting wrapper around an elastic program."""

    def __init__(self, program, plan: FaultPlan, *, reassign_data: bool = False,
                 async_clock: bool | None = None):
        if getattr(program, "elastic", None) is None:
            raise ValueError("SimCluster needs a program with an ElasticContext attached")
        plan.validate(program.replicas)
        self.program = program
        self.plan = plan
        self.replicas = program.replicas
        self.reassign_data = reassign_data
        self._straggle: dict[int, int] = {}  # replica -> rounds left to miss
        self.history: list[dict] = []
        self._async_events: list[dict] = []  # per-sync records the loop drains
        self.blocked_syncs = 0     # forced self-pairs while peers existed
        self.max_staleness = 0     # max τ any exchange contributed
        has_rates = bool(plan.rate_events())
        if async_clock is None:
            async_clock = has_rates
        if has_rates and not async_clock:
            raise ValueError(
                "the fault plan has rate events but async_clock=False: rate "
                "multipliers only act through the asynchronous replica clock"
            )
        self.clock: ReplicaClock | None = None
        if async_clock:
            if not hasattr(program, "outer_step_async"):
                raise ValueError("asynchronous clock needs a program exposing outer_step_async")
            ccfg = self._comm_cfg()
            if ccfg is not None and (ccfg.streams > 1 or ccfg.overlap):
                raise ValueError(
                    "the asynchronous replica clock does not compose with "
                    "streaming outer steps / φ-prefetch yet — run with "
                    "streams=1, overlap=False"
                )
            self.clock = ReplicaClock(self.replicas, self._inner_steps())

    @property
    def membership(self) -> pairing_lib.Membership:
        return self.program.membership

    @property
    def membership_epoch(self) -> int:
        return self.program.membership_epoch

    @property
    def rank(self) -> int:
        """The program's rank in a replica group (0 for the stacked one)."""
        return getattr(self.program, "rank", 0)

    def _inner_steps(self) -> int:
        # both runtimes expose the cadence through their outer config
        prog = self.program
        if hasattr(prog, "tcfg"):
            return prog.tcfg.outer.inner_steps
        return prog.trainer.outer_cfg.inner_steps

    def _comm_cfg(self):
        prog = self.program
        if hasattr(prog, "tcfg"):
            return prog.tcfg.comm
        return getattr(prog.trainer, "comm_cfg", None)

    def _apply(self, state, ev: FaultEvent, t: int):
        mem = self.program.membership
        rec: dict[str, Any] = {"event": ev.kind, "step": t}
        if ev.kind == "drop":
            self.program.set_membership(mem.drop(ev.replicas))
            rec["replicas"] = sorted(ev.replicas)
        elif ev.kind == "rejoin":
            source = ev.source
            if source is None:
                candidates = [r for r in mem.active_ids if r not in ev.replicas]
                if not candidates:
                    raise ValueError("rejoin needs at least one live peer to warm-start from")
                source = candidates[0]
            if source in ev.replicas or not mem.mask[source]:
                raise ValueError(f"rejoin source {source} is not a live peer")
            for r in ev.replicas:
                if mem.mask[r]:
                    raise ValueError(f"replica {r} is already active; cannot rejoin")
                state = self.program.warm_start(state, r, source)
            self.program.set_membership(mem.add(ev.replicas))
            rec["replicas"] = sorted(ev.replicas)
            rec["source"] = source
        elif ev.kind == "straggle":
            for r in ev.replicas:
                if not mem.mask[r]:
                    raise ValueError(f"straggler {r} is not an active replica")
                self._straggle[r] = max(self._straggle.get(r, 0), ev.rounds)
            rec["replicas"] = sorted(ev.replicas)
            rec["rounds"] = ev.rounds
        elif ev.kind == "rate":
            self.clock.set_rate(ev.replicas, ev.rate)   # rate events imply the clock
            rec["replicas"] = sorted(ev.replicas)
            rec["rate"] = ev.rate
        elif ev.kind == "partition":
            self.program.set_partition(ev.groups)
            rec["groups"] = [sorted(g) for g in ev.groups]
        elif ev.kind == "heal":
            self.program.set_partition(None)
        self.history.append(rec)
        return state

    # -- TrainProgram surface ----------------------------------------------

    def init_state(self, example_batch: dict):
        return self.program.init_state(example_batch)

    def inner_step(self, state, batch: dict):
        t = self.program.inner_step_index(state)
        for ev in self.plan.events_at(t, self._inner_steps()):
            state = self._apply(state, ev, t)
        if self.clock is not None:
            # replicas whose clock did not grant this tick a step are frozen
            # through the program's active mask
            grant = self.clock.tick(np.asarray(self.program.membership.mask))
            self.program.elastic.tick_active = grant
        if self.reassign_data and not self.program.membership.is_full:
            table = stream_assignment(self.program.membership, t)
            batch = {k: np.take(v, table, axis=0) for k, v in batch.items()}
        return self.program.inner_step(state, batch)

    def _blocked_count(self, partner, participants: set[int]) -> int:
        """Forced self-pairs: participants the table left alone while other
        participants existed."""
        if partner is None or len(participants) <= 1:
            return 0
        return sum(1 for r in participants if int(partner[r]) == r)

    def _record(self, round_idx: int, absent: frozenset, extra: dict) -> int:
        """Append the round's history record; returns its blocked count."""
        partner = self.program.last_partner   # the table the round used
        participants = set(self.program.membership.active_ids) - absent
        blocked = self._blocked_count(partner, participants)
        self.blocked_syncs += blocked
        self.history.append({
            "event": "round",
            "round": round_idx,
            "active": list(self.program.membership.active_ids),
            "absent": sorted(absent),
            **extra,
            "partner": None if partner is None else [int(p) for p in partner],
            "blocked": blocked,
            "partition": (None if self.program.partition is None
                          else [sorted(g) for g in self.program.partition]),
        })
        return blocked

    def _absent(self, mask) -> frozenset:
        return frozenset(r for r, k in self._straggle.items() if k > 0 and mask[r])

    def maybe_outer_step(self, state):
        if self.clock is not None:
            return self._maybe_outer_step_async(state)
        if not self.program.sync_due(state):
            return state, False
        round_idx = self.program.outer_round_index(state)
        absent = self._absent(self.program.membership.mask)
        self.program.round_absent = absent
        state, synced = self.program.maybe_outer_step(state)
        self._straggle = {r: k - 1 for r, k in self._straggle.items() if k > 1}
        blocked = self._record(round_idx, absent, {})
        if synced:
            participants = set(self.program.membership.active_ids) - absent
            self._async_events.append({
                "mode": "sync", "sync_index": round_idx, "due": sorted(participants),
                "staleness": [0] * self.replicas, "max_staleness": 0, "blocked": blocked,
            })
        return state, synced

    def _maybe_outer_step_async(self, state):
        """One merged sync tick of the asynchronous clock, if any replica is
        due: pairing over all round participants, the update applied by the
        due set, contributions stamped with their staleness."""
        mem_mask = np.asarray(self.program.membership.mask, dtype=bool)
        due = self.clock.due_mask(mem_mask)
        absent = self._absent(mem_mask)
        if absent:
            due = due.copy()
            due[list(absent)] = False
        if not due.any():
            return state, False
        tick = self.clock.merged_tick
        staleness = self.clock.staleness()
        self.program.round_absent = absent
        state, synced = self.program.outer_step_async(
            state, sync_index=tick, due=due, staleness=staleness)
        self.clock.advance_sync(due)
        self._straggle = {r: k - 1 for r, k in self._straggle.items() if k > 1}
        due_ids = [int(r) for r in np.nonzero(due)[0]]
        stale = [int(s) for s in staleness]
        blocked = self._record(tick, absent, {"due": due_ids, "staleness": stale})
        max_tau = max((stale[r] for r in due_ids), default=0)
        self.max_staleness = max(self.max_staleness, max_tau)
        if synced:
            self._async_events.append({
                "mode": "async", "sync_index": tick, "due": due_ids, "staleness": stale,
                "max_staleness": max_tau, "blocked": blocked,
            })
        return state, synced

    def eval_step(self, state, batch: dict) -> float:
        return self.program.eval_step(state, batch)

    def weight_std(self, state) -> float:
        return self.program.weight_std(state)

    def state_pytree(self, state) -> dict:
        """The program's tree plus ``sim``: the in-flight straggler debts
        (they may outlive a run's horizon) and the replica clocks."""
        tree = self.program.state_pytree(state)
        if tree is None:   # a replica group's rank other than 0 writes nothing
            return None
        straggle = np.zeros((self.replicas,), dtype=np.int64)
        for r, k in self._straggle.items():
            straggle[r] = k
        tree["sim"] = {"straggle": straggle}
        if self.clock is not None:
            tree["sim"]["clock"] = self.clock.state_dict()
        return tree

    def load_state_pytree(self, state, tree: dict):
        state = self.program.load_state_pytree(state, tree)
        if "sim" in tree:
            straggle = np.asarray(tree["sim"]["straggle"])
            self._straggle = {int(r): int(k) for r, k in enumerate(straggle) if k > 0}
            if "clock" in tree["sim"]:
                if self.clock is None:
                    self.clock = ReplicaClock(self.replicas, self._inner_steps())
                self.clock.load_state_dict(tree["sim"]["clock"])
        return state

    def comm_cost(self):
        return self.program.comm_cost()

    # -- program passthrough (the loop's ranks, telemetry and end) ------------

    def barrier(self) -> None:
        barrier = getattr(self.program, "barrier", None)
        if barrier is not None:
            barrier()

    def finish(self, state):
        finish = getattr(self.program, "finish", None)
        return state if finish is None else finish(state)

    def drain_recompile_events(self) -> list[dict]:
        drain = getattr(self.program, "drain_recompile_events", None)
        return [] if drain is None else drain()

    def pool_stats(self) -> dict | None:
        stats = getattr(self.program, "pool_stats", None)
        return None if stats is None else stats()

    def drain_stream_events(self) -> list[dict]:
        """The program's ``stream_sync`` records.  A streaming program syncs
        one stream per due step, so a straggle debt is spent per stream
        sync, not per full cycle: a one-round straggle misses one stream's
        exchange."""
        drain = getattr(self.program, "drain_stream_events", None)
        return [] if drain is None else drain()

    def drain_async_events(self) -> list[dict]:
        """Per-sync participation and staleness records since the last
        drain (both clock modes), which the loop turns into ``outer_async``
        events and the ``max_staleness`` / ``blocked_syncs`` summary."""
        events, self._async_events = self._async_events, []
        return events

    def rounds(self) -> list[dict]:
        """The per-round participation records of ``history``."""
        return [h for h in self.history if h["event"] == "round"]
