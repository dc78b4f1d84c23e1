"""Distributed NoLoCo training over ``torch.distributed``: ``--model``
ranks per replica (one by default), each holding its part of its replica
on its own device.

The port of ``repro/launch/train_distributed.py``.
Every rank runs its inner AdamW steps with no cross-rank call (unless
``--method fsdp`` all-reduces the gradients every step); every m steps
the outer step moves the packed (Δ, φ) payload to the round's partner and
back in one batched send/receive (NoLoCo: no collective), or all-reduces
Δ (DiLoCo).  The pairings are the reference's
:class:`~repro_torch.parallel.steps.OuterProgramPool` slots
(``--pairing-pool``, ``--schedule random|hypercube``), so a run's
partners are the JAX package's.  The step loop, eval cadence, telemetry
and checkpoints are the engine's (:mod:`repro_torch.train`, through
:class:`~repro_torch.train.adapters.DistributedProgram`): every rank runs
the loop, rank 0 writes; checkpoints are JAX's ``DistributedProgram``
layout, so either package resumes the other's.

Elastic, asynchronous and streamed rounds (``--fault-plan``,
``--reassign-data``, ``--stale``, ``--overlap``, ``--stream-count``): every
rank wraps its program in its own :class:`~repro_torch.sim.SimCluster`
from the same plan and seed, so the ranks agree on each round's
membership, stragglers and clocks with no message.  A dropped replica's
rank, or one the asynchronous clock did not grant a tick, makes no inner
step and keeps its rows; every rank still joins each collective.  A rejoin
is one send of the source's φ to the rejoining rank.  Pairings over a
partial view pair the view's members and leave every other rank with
itself, which moves nothing.  With streams each stream's φ′ pre-send is
posted without a wait and stays in flight during the inner steps until
the stream's next sync.

    # four ranks sharing one card, the payload staged through host memory:
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --data 4 \\
        --batch-per-replica 4 --seq 1024 --steps 10 --inner-steps 5 --backend gloo

    # one rank per card, NCCL between them:
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --data 4 --backend nccl

    # the reduced model on four CPU processes:
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --device cpu \\
        --backend gloo --reduced --data 4 --steps 8 --inner-steps 4 --seq 32

    # the same under a fault plan, and with four streams:
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --device cpu \\
        --reduced --data 4 --steps 24 --inner-steps 4 --seq 32 --fault-plan plan.json
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --device cpu \\
        --reduced --data 4 --steps 24 --inner-steps 4 --seq 32 --stream-count 4

The launcher spawns ``--data`` ranks with a ``file://`` rendezvous in a
temporary directory; under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set)
each process is one rank instead.  ``--device`` defaults to ``cuda`` and
raises without a GPU; ``--backend nccl`` with more ranks than cards
raises and names ``--backend gloo``.  The last stdout line is the JAX
CLI's summary JSON plus ``method``, ``device`` and ``backend``.

The model axis (``--model N``): a replica's weights are split over N
ranks (tensor parallelism: heads, d_ff and vocabulary; expert parallelism
for MoE blocks), which run the reference's collectives over their
subgroup (``parallel/sharding.py``); the world is ``--data × --model``
ranks, rank r holding model index r % N of replica r // N.  NoLoCo's outer
step stays one send/receive per rank: each rank exchanges its shards with
the rank of the partner replica that holds its model index.  Checkpoints
hold the whole replicas (the JAX package's global arrays): rank 0 writes
the gathered tree and each rank cuts its shard on resume, so a checkpoint
does not depend on ``--model``.  Refused by name at ``--model`` > 1:
``--fault-plan``, ``--reassign-data``, ``--stale momentum``, ``--overlap``
and ``--stream-count`` > 1 (ROADMAP Queue 1 item 9e).  The last stdout line
carries ``fault_events`` and ``membership`` under a fault plan, as the
reference's does.

    # two replicas of two model ranks each, sharing one card:
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --data 2 --model 2

The ``fsdp_hybrid`` plan (ZeRO-3 over a data axis inside each replica, the
replicas being pods) is reached through the trainer API, as in the
reference, whose CLI always makes ``gossip_dp``: build the trainer with
``plan=plans.make_plan("fsdp_hybrid", data, model, pod=pods)`` on a group
of ``pods × data × model`` ranks (``mesh.spawn(..., tp=model,
fsdp=data)``).  Each rank holds its (data, model) shard of its pod's
replica and trains on its data index's rows of the replica's batch;
NoLoCo's outer step stays one batched send/receive per rank, carrying its
shards to the rank at its (data, model) place in the partner pod, and
DiLoCo all-reduces over the ranks at that place.  Checkpoints still hold
whole replicas (gathered over data, then over model).  The CLI's
``--method fsdp`` is another thing: the per-step gradient all-reduce
baseline over the replicas.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any

import numpy as np
import torch

from repro_torch.comm import CommConfig
from repro_torch.comm import payload as payload_lib
from repro_torch.comm import bytes_model
from repro_torch.configs import registry
from repro_torch.core.elastic import ELASTIC_METHODS, ElasticContext
from repro_torch.core.outer import OuterConfig, StreamSchedule
from repro_torch.data import LoaderConfig
from repro_torch.launch import mesh
from repro_torch.models import model as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.parallel import plans as plans_lib
from repro_torch.parallel import steps as steps_lib
from repro_torch.sim.faults import FaultPlan
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["DistributedTrainer", "build_parser", "check_args", "run_rank", "main"]


@dataclasses.dataclass
class DistributedTrainer:
    """The step functions and this rank's replica state.

    State: ``{"theta", "opt", "phi", "delta"}`` trees with a leading axis
    of 1 (this rank's replica), ``"outer_step"`` and ``"inner_step"``
    ints, and with the §3.2 overlap ``"phi_pre"`` (the partner's φ of each
    stream, pre-sent at the stream's last sync).  ``partners`` records the
    partner table of every NoLoCo round.

    ``elastic`` (an :class:`~repro_torch.core.elastic.ElasticContext`,
    which every rank's :class:`~repro_torch.sim.SimCluster` drives from the
    same plan, so the ranks agree on the membership with no message): a
    rank whose replica is inactive this step (dropped, or not granted a
    tick by the asynchronous clock) makes no inner step and keeps its
    rows; every rank still joins every collective."""

    cfg: ModelConfig
    group: Any                    # launch.mesh.ReplicaGroup
    plan: plans_lib.Plan
    outer_cfg: OuterConfig
    inner_cfg: AdamWConfig
    comm_cfg: CommConfig = dataclasses.field(default_factory=CommConfig)
    pairing_pool: int = 16        # random matchings, cycled
    schedule: str = "random"      # "random" pool | "hypercube" (log2 N slots)
    seed: int = 0
    data_sync: bool = False       # DDP/FSDP baseline: mean the gradients every step
    elastic: ElasticContext | None = None   # None: a fixed world

    def __post_init__(self):
        self.outer_cfg.validate()
        self.comm_cfg.validate()
        if self.plan.world != self.group.world:
            raise ValueError(f"plan needs {self.plan.world} ranks, the group has "
                             f"{self.group.world}")
        if (self.plan.fsdp, self.plan.tp) != (self.group.fsdp, self.group.tp):
            raise ValueError(f"plan lays a replica over {self.plan.fsdp} data × {self.plan.tp} "
                             f"model ranks, the group over {self.group.fsdp} × "
                             f"{self.group.tp}")
        if self._split() and (self.elastic is not None or self.comm_cfg.streams > 1
                              or self.comm_cfg.overlap or self.outer_cfg.stale != "naive"):
            raise NotImplementedError("elastic, asynchronous and streamed rounds with a model "
                                      f"axis or under {self.plan.name} come with "
                                      f"{plans_lib.ITEM_9E}")
        if self.elastic is not None and self.elastic.world != self.plan.replicas:
            raise ValueError(f"elastic world {self.elastic.world} != plan replicas "
                             f"{self.plan.replicas}")
        if self.elastic is not None and (self.data_sync
                                         or self.outer_cfg.method not in ELASTIC_METHODS):
            raise ValueError(f"an elastic run takes method {' or '.join(ELASTIC_METHODS)}, "
                             "without data_sync: a replica that sits a step out would "
                             "leave the others waiting in the gradient all-reduce")
        if self.comm_cfg.streams > 1 and self.outer_cfg.method != "noloco":
            raise ValueError("streams > 1 is a noloco-only feature (gossip pairing)")
        # streaming outer steps: staggered per-stream syncs, for streams > 1
        # or the φ-prefetch overlap (one stream)
        self._streaming = self.outer_cfg.method == "noloco" and (
            self.comm_cfg.streams > 1 or self.comm_cfg.overlap)
        self._schedule = self._pre_partner = self._pre_epoch = None
        if self._streaming:
            s = self.comm_cfg.streams
            self._schedule = StreamSchedule(self.outer_cfg.inner_steps, s)
            self._pre_partner = np.full((s, self.plan.replicas), -1, np.int64)
            self._pre_epoch = np.full((s,), -1, np.int64)
        self._pending: dict[int, Any] = {}   # stream -> its φ′ pre-send in flight
        self._stream_cost = None
        self.device = self.group.device
        self.replica = self.plan.replica_of(self.group.rank)
        self.partners: list[np.ndarray] = []
        self.recompile_events: list[dict] = []
        self.stream_events: list[dict] = []

    def initial_params(self) -> PyTree:
        """One replica's starting weights, whole, on the CPU: every replica
        starts from the same point, drawn from ``seed`` as the stacked
        runtime draws it."""
        return model_api.init_params(torch.Generator().manual_seed(self.seed), self.cfg)

    def _split(self) -> bool:
        return self.plan.tp > 1 or self.plan.fsdp > 1

    def shard(self, stacked: PyTree) -> PyTree:
        """This rank's (data, model) shard of a whole replica-stacked tree
        (itself without a model or data axis)."""
        if not self._split():
            return stacked
        return steps_lib.shard_params(stacked, self.cfg, self.plan, self.group.model_index,
                                      data_index=self.group.data_index)

    def gather(self, tree: PyTree) -> PyTree:
        """The whole replica-stacked tree from this rank's shard: every
        leaf split over the data axis all-gathered over it, then every leaf
        split over the model axis over that (itself without either axis)."""
        if not self._split():
            return tree
        return steps_lib.gather_shards(tree, self.cfg, self.plan, self.group.model,
                                       data=self.group.data)

    def init_state(self, batch_example: dict | None = None) -> dict:
        theta = self.shard(tree_map(lambda p: p.unsqueeze(0), self.initial_params()))
        theta = tree_map(lambda p: p.to(self.device).contiguous(), theta)
        self.bundle = steps_lib.build_train_step(self.cfg, self.plan, self.group,
                                                 self.inner_cfg, data_sync=self.data_sync)
        self._partition = None
        if self._streaming:
            # the stacked struct's partition, as the reference draws it (the
            # midpoint rule does not depend on the replica axis)
            self._partition = payload_lib.stream_partition(self.theta_struct(),
                                                           self.comm_cfg.streams,
                                                           fuse=self.comm_cfg.fuse)
        self.pool = steps_lib.OuterProgramPool(
            self.plan, self.outer_cfg, group=self.group, comm_cfg=self.comm_cfg,
            schedule=self.schedule, pairing_pool=self.pairing_pool, seed=self.seed,
            partition=self._partition)
        self._pending = {}
        state = {"theta": theta, "opt": steps_lib.init_opt_state(theta),
                 "phi": tree_map(torch.clone, theta), "delta": tree_map(torch.zeros_like, theta),
                 "outer_step": 0, "inner_step": 0}
        if self.comm_cfg.overlap:
            # every replica starts from the same φ_0, so the partner's φ for
            # the first sync is this rank's own copy
            state["phi_pre"] = tree_map(torch.clone, state["phi"])
        return state

    # -- elastic -------------------------------------------------------------

    def active(self) -> bool:
        """Whether this rank's replica steps now: a member whose clock (if
        any) granted this tick."""
        mask = None if self.elastic is None else self.elastic.active_array()
        return mask is None or bool(mask[self.replica])

    def member(self) -> bool:
        """Whether this rank's replica is in the membership."""
        return self.elastic is None or bool(self.elastic.membership.mask[self.replica])

    @torch.no_grad()
    def warm_start(self, state: dict, replica: int, source: int) -> dict:
        """Rejoin: replica ``source`` sends its φ to ``replica`` in one
        send, and no other rank makes a call.  The rejoining rank sets
        θ = φ = that value and zeroes δ, both AdamW moments and the count;
        every other rank's state is unchanged."""
        if self.replica == source:
            buffers, _ = payload_lib.pack(state["phi"], fuse=True)
            self.group.send(buffers, dst=replica)
            return state
        if self.replica != replica:
            return state
        buffers, spec = payload_lib.pack(state["phi"], fuse=True)
        phi = payload_lib.unpack(self.group.recv(buffers, src=source), spec)
        for m in tree_leaves(state["opt"].mu) + tree_leaves(state["opt"].nu):
            m.zero_()
        opt = AdamWState(mu=state["opt"].mu, nu=state["opt"].nu,
                         count=torch.zeros_like(state["opt"].count))
        return dict(state, theta=phi, phi=phi, delta=tree_map(torch.zeros_like, state["delta"]),
                    opt=opt)

    # -- steps ---------------------------------------------------------------

    def inner_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One AdamW step of this rank's replica on its (1, B, S) batch.  A
        replica that sits the step out launches nothing and keeps its
        rows; its loss is NaN (no loss), left out of the step's mean."""
        if not self.active():
            return dict(state, inner_step=state["inner_step"] + 1), {
                "loss": torch.full((1,), float("nan"))}
        theta, opt, metrics = self.bundle.step_fn(state["theta"], state["opt"], batch)
        return dict(state, theta=theta, opt=opt, inner_step=state["inner_step"] + 1), metrics

    def outer_index(self, state: dict) -> int:
        """The round the next outer step runs (0-indexed)."""
        return state["inner_step"] // self.outer_cfg.inner_steps - 1

    @staticmethod
    def _table_of(pairs) -> np.ndarray:
        """Partner table (destination by source) of a pair list."""
        return np.asarray([d for _, d in pairs], dtype=np.int64)

    def _partner_fn(self, key: int):
        return lambda parts: self._table_of(self.pool.pairs_for(key, parts,
                                                                self.elastic.partition)[1])

    def _run(self, state: dict, fn, info: dict, key: int, partner) -> dict:
        if self.outer_cfg.method == "noloco" and partner is not None:
            self.partners.append(np.asarray(partner, dtype=np.int64))
        t0 = time.time()
        theta, phi, delta, step = fn(state["theta"], state["phi"], state["delta"],
                                     state["outer_step"])
        self._drain_compiles(info, t0, key)
        return dict(state, theta=theta, phi=phi, delta=delta, outer_step=step)

    def _drain_compiles(self, info: dict, t0: float, outer_index: int) -> None:
        """A pool miss's first call: one ``recompile`` record per event."""
        if info["compiled"]:
            for ev in self.pool.drain_events():
                self.recompile_events.append(dict(ev, wall_s=round(time.time() - t0, 4),
                                                  outer_index=outer_index))

    def maybe_outer_step(self, state: dict) -> tuple[dict, bool]:
        if self._streaming:
            return self._maybe_stream_sync(state)
        if state["inner_step"] % self.outer_cfg.inner_steps:
            return state, False
        outer_index = self.outer_index(state)
        noloco = self.outer_cfg.method == "noloco"
        if self.elastic is None:
            fn, info = self.pool.program(outer_index)
            partner = self._table_of(self.pool.pairs_for(outer_index)[1]) if noloco else None
        else:
            plan = self.elastic.plan_round(self._partner_fn(outer_index) if noloco else None)
            if plan.all_absent:
                fn, info = self._all_absent_program()
            else:
                fn, info = self.pool.program(outer_index, plan.participants,
                                             self.elastic.partition)
            partner = plan.partner
        return self._run(state, fn, info, outer_index, partner), True

    def outer_step_async(self, state: dict, *, sync_index: int, due, staleness
                         ) -> tuple[dict, bool]:
        """One merged sync tick of the asynchronous clock.  The pairing is
        drawn over all round participants at key ``sync_index``, so a
        participant that is not due is a passive source (its (Δ, φ) moves,
        its state stays); only ``due`` replicas update, and under
        ``stale="momentum"`` each Δ on the wire is discounted by its
        staleness.  The all-due τ = 0 tick is the synchronous entry."""
        if self.outer_cfg.method != "noloco":
            raise ValueError("asynchronous merged-tick sync is NoLoCo-only")
        if self._streaming:
            raise ValueError("the asynchronous clock does not compose with streaming "
                             "outer steps / φ-prefetch yet")
        if self.elastic is None:
            raise ValueError("outer_step_async needs an ElasticContext")
        plan = self.elastic.plan_round(self._partner_fn(sync_index))
        if plan.all_absent:
            fn, info = self._all_absent_program()
        else:
            update = np.asarray(due, dtype=bool).copy()
            tau = np.asarray(staleness)
            if plan.active is not None:
                update &= np.asarray(plan.active, dtype=bool)
            if update.all() and not tau.any():
                fn, info = self.pool.program(sync_index, plan.participants,
                                             self.elastic.partition)
            else:
                stale = tau if self.outer_cfg.stale == "momentum" and tau.any() else None
                fn, info = self.pool.program(sync_index, plan.participants,
                                             self.elastic.partition, update_mask=update,
                                             staleness=stale)
        return self._run(state, fn, info, sync_index, plan.partner), True

    def _all_absent_program(self) -> tuple[Any, dict]:
        """The round in which every live replica timed out (the pool's
        ``"all-absent"`` entry)."""
        return self.pool.all_absent()

    # -- streams -------------------------------------------------------------

    def _merge_pending(self, state: dict, streams) -> dict:
        """``state`` with the φ′ pre-sends of ``streams`` waited and written
        into ``phi_pre``."""
        leaves = None
        for k in streams:
            pending = self._pending.get(k)
            if pending is None:
                continue
            if leaves is None:
                leaves = list(tree_leaves(state["phi_pre"]))
            for i, leaf in zip(self._partition.leaf_indices(k), pending.wait()):
                leaves[i] = leaf
        if leaves is None:
            return state
        return dict(state, phi_pre=tree_unflatten(state["phi_pre"], leaves))

    def settled(self, state: dict) -> dict:
        """``state`` with every pre-send in flight waited and in
        ``phi_pre`` (before a checkpoint gathers it); the transfers stay
        the streams' own, so their next syncs find them done."""
        return self._merge_pending(state, sorted(self._pending))

    def finish(self, state: dict) -> dict:
        """The end of a run: every pre-send in flight is waited (both sides
        posted it) and written into ``phi_pre``."""
        state = self.settled(state)
        self._pending = {}
        return state

    @property
    def streaming(self) -> bool:
        """Streamed outer syncs (streams > 1 or the φ-prefetch overlap)."""
        return self._streaming

    def round_index(self, inner_step: int) -> int:
        """The pairing key of the round due at ``inner_step``: a stream's
        global sync index when streaming, else the 0-indexed round."""
        if self._streaming:
            k = self._schedule.due(inner_step)
            if k is not None:
                return self._schedule.sync_index(k, inner_step)
        return inner_step // self.outer_cfg.inner_steps - 1

    def sync_due(self, inner_step: int) -> bool:
        """Whether an outer sync (a stream's, when streaming) is due at
        ``inner_step``."""
        if self._streaming:
            return self._schedule.due(inner_step) is not None
        return inner_step > 0 and inner_step % self.outer_cfg.inner_steps == 0

    def stream_state(self) -> dict | None:
        """The streams' pre-send record in JAX's checkpoint layout
        (``pre_partner``: each stream's pre-send table, ``pre_epoch``: its
        membership epoch, −1 for none); None without streaming."""
        if not self._streaming:
            return None
        return {"pre_partner": self._pre_partner.copy(), "pre_epoch": self._pre_epoch.copy()}

    def load_stream_state(self, tree: dict | None) -> None:
        """Restore :meth:`stream_state` and forget the pre-sends in
        flight.  ``None`` (a checkpoint written without streaming):
        nothing was pre-sent, so every stream's next sync blocks."""
        self._pending = {}
        if not self._streaming:
            return
        if tree is None:
            self._pre_partner = np.full_like(self._pre_partner, -1)
            self._pre_epoch = np.full_like(self._pre_epoch, -1)
        else:
            self._pre_partner = np.asarray(tree["pre_partner"]).astype(np.int64)
            self._pre_epoch = np.asarray(tree["pre_epoch"]).astype(np.int64)

    def pre_partner(self, k: int) -> np.ndarray:
        """Stream ``k``'s last pre-send table."""
        return self._pre_partner[k].copy()

    def stream_cost(self):
        """The byte model's cost of a NoLoCo sync, per stream."""
        if self._stream_cost is None:
            self._stream_cost = bytes_model.outer_step_cost(
                bytes_model.abstract_params(self.cfg), self.comm_cfg, method="noloco",
                world=self.plan.replicas)
        return self._stream_cost

    def _maybe_stream_sync(self, state: dict) -> tuple[dict, bool]:
        """One stream's staggered sync.  Stream k's pre-send in flight is
        waited first and its φ′ written into ``phi_pre``.  The prefetch is
        consumed only when it was pre-sent under this membership epoch
        along this round's table; otherwise this stream alone blocks on
        (Δ, φ) (an epoch fallback, a pool lookup).  Then the stream's φ′
        is pre-sent along its next pairing (key ``i + streams`` over the
        membership) and left in flight."""
        t = state["inner_step"]
        k = self._schedule.due(t)
        if k is None:
            return state, False
        i = self._schedule.sync_index(k, t)
        streams = self._schedule.stream_count
        overlap = self.comm_cfg.overlap
        state = self._merge_pending(state, [k])
        self._pending.pop(k, None)
        epoch = 0 if self.elastic is None else self.elastic.epoch
        groups = None if self.elastic is None else self.elastic.partition
        participants = None
        if self.elastic is None:
            partner = self._table_of(self.pool.pairs_for(i)[1])
        else:
            plan = self.elastic.plan_round(self._partner_fn(i))
            if plan.all_absent:
                # nothing moves and nobody updates; the pre-send planned
                # for this sync is spent and none is made for the next
                fn, info = self._all_absent_program()
                state = self._run(state, fn, info, i, plan.partner)
                self._pre_epoch[k] = -1
                self._record_stream_event(k, i, consume=False, had_prefetch=False)
                return state, True
            participants, partner = plan.participants, np.asarray(plan.partner, np.int64)
        had_prefetch = bool(self._pre_epoch[k] >= 0)
        consume = bool(overlap and "phi_pre" in state and self._pre_epoch[k] == epoch
                       and np.array_equal(self._pre_partner[k], partner))
        presend_index = i + streams if overlap else None
        presend_membership = None if self.elastic is None else self.elastic.membership
        fn, info = self.pool.program(i, participants, groups, stream=k, consume=consume,
                                     presend_index=presend_index,
                                     presend_membership=presend_membership)
        self.partners.append(partner)
        t0 = time.time()
        theta, phi, delta, step, pending = fn(state["theta"], state["phi"], state["delta"],
                                              state["outer_step"], state.get("phi_pre"))
        self._drain_compiles(info, t0, i)
        if pending is not None:
            self._pending[k] = pending
        if overlap:
            self._pre_partner[k] = self._table_of(
                self.pool.pairs_for(presend_index, presend_membership, groups)[1])
            self._pre_epoch[k] = epoch
        self._record_stream_event(k, i, consume=consume, had_prefetch=had_prefetch)
        return dict(state, theta=theta, phi=phi, delta=delta, outer_step=step), True

    def _record_stream_event(self, k: int, i: int, *, consume: bool, had_prefetch: bool) -> None:
        sc = self.stream_cost().per_stream[k]
        blocking = sc.blocking_bytes if consume else sc.payload_bytes
        self.stream_events.append({
            "stream": k, "offset": self._schedule.offsets[k], "sync_index": i,
            "payload_bytes": sc.payload_bytes, "blocking_bytes": blocking,
            "overlapped_bytes": sc.payload_bytes - blocking, "blocked": not consume,
            "epoch_fallback": bool(self.comm_cfg.overlap and not consume and had_prefetch),
        })

    # -- eval ------------------------------------------------------------------

    def eval_loss(self, state: dict, batch: dict) -> torch.Tensor:
        """Grad-free loss of this rank's replica, (1,); NaN (nothing run)
        for a replica out of the membership."""
        if not self.member():
            return torch.full((1,), float("nan"), device=self.device)
        return self.bundle.eval_fn(state["theta"], batch)

    def theta_struct(self) -> PyTree:
        """Stacked-θ :class:`~repro_torch.comm.payload.LeafShape`\\ s, every
        replica's (for static comm costing)."""
        r = self.plan.replicas
        return tree_map(lambda x: payload_lib.LeafShape((r,) + tuple(x.shape), x.dtype),
                        bytes_model.abstract_params(self.cfg))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-small-125m")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the arch")
    ap.add_argument("--method", default="noloco", choices=["noloco", "diloco", "fsdp", "none"],
                    help="outer method (fsdp: the gradient all-reduced every step)")
    ap.add_argument("--data", type=int, default=4, help="replicas: one rank each")
    ap.add_argument("--model", type=int, default=1, help="model-axis ranks a replica")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--inner-steps", type=int, default=10)
    ap.add_argument("--batch-per-replica", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedule", default="random", choices=["random", "hypercube"])
    ap.add_argument("--pairing-pool", type=int, default=16,
                    help="random-schedule matchings, cycled")
    ap.add_argument("--codec", default="none", choices=["none", "fp16", "bf16", "int8"],
                    help="gossip wire codec")
    ap.add_argument("--no-fuse", action="store_true",
                    help="one message per leaf instead of one fused buffer per dtype")
    ap.add_argument("--overlap", action="store_true",
                    help="§3.2 φ-prefetch: pre-send φ′ along the next pairing, in flight during "
                         "the inner steps (on with --stream-count > 1)")
    ap.add_argument("--stream-count", type=int, default=1,
                    help="partition the outer payload into N streams synced on staggered "
                         "round offsets (streaming outer steps)")
    ap.add_argument("--fault-plan", default=None,
                    help="JSON FaultPlan (repro_torch.sim.faults): run the replica group "
                         "elastically under churn")
    ap.add_argument("--reassign-data", action="store_true",
                    help="redistribute dropped replicas' loader streams over survivors")
    ap.add_argument("--stale", default="naive", choices=["naive", "momentum"],
                    help="async stale-Δ rule for a fault plan with rate events: naive applies "
                         "a delayed Δ as-is, momentum discounts it by 1/(1+τ)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (the JAX package's format)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save every N steps (0: only a final save)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint under --ckpt-dir")
    ap.add_argument("--log-jsonl", default=None,
                    help="append one JSON telemetry event per line to this file (rank 0)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of every rank (default cuda; cpu runs the plain versions)")
    ap.add_argument("--backend", default="gloo", choices=list(mesh.BACKENDS),
                    help="gloo (host memory; ranks may share a card) or nccl (one card a rank)")
    ap.add_argument("--out", default=None,
                    help="write every rank's per-step losses and the partner tables here")
    return ap


def check_args(args: argparse.Namespace) -> None:
    """Refuse, by name, what this path does not run yet (item 9b's flags
    with a model axis), and a fault plan under a method the stacked elastic
    CLI refuses."""
    if args.model > 1:
        flags = [f for f, on in (("--fault-plan", args.fault_plan),
                                 ("--reassign-data", args.reassign_data),
                                 ("--stale momentum", args.stale != "naive"),
                                 ("--overlap", args.overlap),
                                 ("--stream-count", args.stream_count > 1)) if on]
        if flags:
            raise NotImplementedError(f"{', '.join(flags)} with --model {args.model} come with "
                                      f"{plans_lib.ITEM_9E}")
    if args.fault_plan and args.method not in ELASTIC_METHODS:
        raise SystemExit(f"argument --method: invalid choice: {args.method!r} "
                         f"(choose from {', '.join(ELASTIC_METHODS)})")


def fault_plan(args: argparse.Namespace) -> FaultPlan | None:
    """The ``--fault-plan`` file's plan, or None for a fixed world."""
    return FaultPlan.load(args.fault_plan) if args.fault_plan else None


def model_config(args: argparse.Namespace) -> ModelConfig:
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=min(cfg.vocab_size, 512), remat=False, dtype="float32")
    return cfg


def make_trainer(args: argparse.Namespace, group, cfg: ModelConfig | None = None, *,
                 plan: plans_lib.Plan | None = None) -> DistributedTrainer:
    """The rank's trainer for the CLI's flags: the reference's inner AdamW
    (constant lr, no weight decay, clipping at 1) and the paper's outer
    settings (NoLoCo α 0.5, DiLoCo α 0.3, β 0.7).  ``plan`` replaces the
    CLI's ``gossip_dp`` plan over ``--data × --model`` (an ``fsdp_hybrid``
    plan, which no flag selects)."""
    method = "none" if args.method == "fsdp" else args.method
    alpha = 0.3 if method == "diloco" else 0.5
    inner_steps = args.inner_steps if method != "none" else 10**9
    plan = plan or plans_lib.make_plan("gossip_dp", args.data, args.model)
    return DistributedTrainer(
        cfg=cfg or model_config(args), group=group, plan=plan,
        outer_cfg=OuterConfig(method=method, alpha=alpha, beta=0.7, inner_steps=inner_steps,
                              stale=args.stale),
        inner_cfg=AdamWConfig(lr=args.lr, weight_decay=0.0),
        comm_cfg=CommConfig(codec=args.codec, fuse=not args.no_fuse,
                            overlap=args.overlap or args.stream_count > 1,
                            streams=args.stream_count),
        pairing_pool=args.pairing_pool, schedule=args.schedule, seed=args.seed,
        data_sync=args.method == "fsdp",
        elastic=ElasticContext(world=plan.replicas) if args.fault_plan else None)


def run_rank(group, args: argparse.Namespace, *, trainer: DistributedTrainer | None = None
             ) -> dict:
    """One rank's run of the CLI: the loop over this rank's replica, under
    its own :class:`~repro_torch.sim.SimCluster` when there is a fault
    plan (every rank replays the same plan).  Returns ``{"result": the
    loop's result (this rank's losses, NaN where it sat a step out),
    "trainer", "sim" (or None), "losses": every rank's per-step losses
    (rank 0), "summary": the CLI's summary (rank 0, else None)}``."""
    from repro_torch.sim import SimCluster
    from repro_torch.train import DistributedProgram, LoopConfig, make_loop

    trainer = trainer or make_trainer(args, group)
    cfg = trainer.cfg
    plan = fault_plan(args)
    program = DistributedProgram(trainer)
    sim = None
    if plan is not None:
        if trainer.elastic is None:
            raise ValueError("a fault plan needs a trainer built with elastic=...")
        sim = program = SimCluster(program, plan, reassign_data=args.reassign_data)
        if group.rank == 0:
            anchor = plan.max_anchor_step(args.inner_steps)
            if anchor >= args.steps:
                print(f"WARNING: fault plan extends to step {anchor} but the run stops at "
                      f"{args.steps}; later events never fire", flush=True)
            elif plan.max_effect_step(args.inner_steps) > args.steps:
                print(f"warning: fault-plan effects (straggle debts) extend to step "
                      f"{plan.max_effect_step(args.inner_steps)}, beyond --steps {args.steps}; "
                      "in-flight debts ride the checkpoint and resume exactly", flush=True)
    loop = make_loop(
        program,
        LoaderConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     per_replica_batch=args.batch_per_replica, replicas=trainer.plan.replicas,
                     seed=args.seed),
        LoopConfig(steps=args.steps, eval_every=args.eval_every, seed=args.seed,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, resume=args.resume,
                   log_jsonl=args.log_jsonl, log=True, run_name=f"{cfg.name}-dist"),
    )
    res = loop.run()
    losses = group.gather_object(res["losses"])
    summary = None
    if group.rank == 0:
        per_step = []
        if res["losses"]:   # the mean over the step's active replicas
            rows = np.asarray(losses, dtype=np.float64)
            per_step = [float(np.mean(c[~np.isnan(c)])) if (~np.isnan(c)).any() else None
                        for c in rows.T]
        pool = trainer.pool.stats()
        dev = group.device
        summary = {
            "arch": cfg.name, "method": args.method, "replicas": trainer.plan.replicas,
            "tp": trainer.plan.tp, "codec": args.codec, "fuse": not args.no_fuse,
            "overlap": trainer.comm_cfg.overlap, "stream_count": args.stream_count,
            "blocking_fraction": round(res["blocking_fraction"], 4),
            "final_loss": per_step[-1] if len(per_step) else None,
            "final_eval": res["evals"][-1][1] if res["evals"] else None,
            "tokens_per_s": round(res["tokens_per_s"], 1),
            "comm_bytes": res["comm_bytes"], "wall_s": round(res["wall_s"], 1),
            "pool": pool, "recompiles": pool["misses"],
        }
        if plan is not None:
            summary["fault_events"] = len(plan.events)
            summary["membership"] = {"epoch": trainer.elastic.epoch,
                                     "active": list(trainer.elastic.active_ids())}
        summary["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        summary["backend"] = group.backend
    return {"result": res, "trainer": trainer, "sim": sim, "losses": losses,
            "summary": summary}


def _spawned(group, argv: dict) -> dict:
    """The spawned rank's entry: the picklable part of :func:`run_rank`."""
    out = run_rank(group, argparse.Namespace(**argv))
    return {"summary": out["summary"], "losses": out["losses"],
            "partners": [p.tolist() for p in out["trainer"].partners],
            "rounds": None if out["sim"] is None else out["sim"].rounds()}


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    check_args(args)
    env = mesh.from_env()
    if env is not None:   # torchrun: this process is one rank
        rank, world = env
        if world != args.data * args.model:
            raise SystemExit(f"--data {args.data} --model {args.model} but torchrun started "
                             f"{world} ranks")
        group = mesh.init_replica_group(world, args.backend, args.device, rank=rank,
                                        tp=args.model)
        try:
            out = _spawned(group, vars(args))
        finally:
            torch.distributed.destroy_process_group()
        if rank:
            return {}
    else:
        out = mesh.spawn(_spawned, args.data * args.model, (vars(args),), backend=args.backend,
                         device=args.device, tp=args.model)[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"losses": out["losses"], "partners": out["partners"],
                       "rounds": out["rounds"]}, f)
    print(json.dumps(out["summary"]))
    return out["summary"]


if __name__ == "__main__":
    main()
