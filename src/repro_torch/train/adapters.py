"""The stacked-simulation, replica-group and routed-pipeline runtimes as
:class:`TrainProgram` implementations (the port of
``repro/train/adapters.py``'s ``GossipProgram``, ``DistributedProgram``
and ``PipelineProgram``).

Replicas sit on a leading axis of every state leaf, on one device: the
card, or the CPU when asked.  Every replica starts from the same weights,
the port's initialisation from ``seed`` drawn on the CPU generator and then
moved to the device, so a card run and a CPU run of the same config start
from the same point.

Elasticity is owned by one :class:`~repro_torch.core.elastic.
ElasticContext` (membership epoch, partition view, per-round stragglers,
the last partner table), which :class:`~repro_torch.sim.SimCluster` and the
loop's telemetry drive through the shared elastic surface
(:class:`_ElasticSurface`).  In the stacked simulation every round's
pairing comes from :func:`~repro_torch.core.pairing.
elastic_partner_table` through ``ElasticContext.plan_round``: dropped
replicas are frozen in inner and outer steps, a replica whose partner
misses the round pairs with itself, and eval, weight std and the reported
loss cover the active replicas only.

Streaming outer steps (``streams > 1``, or the §3.2 φ-prefetch overlap,
which is one stream): each stream syncs on its own round offset
(:class:`~repro_torch.core.outer.StreamSchedule`) at the pairing key of its
global sync index, and pre-sends its φ′ along its next pairing; the
prefetch is consumed only under the same membership epoch and partner
table, else that stream alone falls back to the blocking exchange.  The
checkpoint view of the state is the JAX ``GossipProgram.state_pytree``
layout, membership and the in-flight ``stream`` state included
(:func:`repro_torch.models.convert.train_state_to_numpy`), so a JAX
checkpoint resumes here and this program's restore in JAX.

The replica group (:class:`DistributedProgram` over :class:`~repro_torch.
launch.train_distributed.DistributedTrainer`, one rank per replica, with
the elastic surface when the trainer has an elastic context): each rank
takes its replica's rows of the loader's stacked batch; eval, the weight
std and checkpoints gather across the ranks outside the outer step, and
the checkpoint is JAX's ``DistributedProgram.state_pytree`` tree, written
by rank 0.

The routed pipeline (:class:`PipelineProgram` over :class:`~repro_torch.
pipeline.PipelineTrainer`): §3.1 random routing between stage replicas and
the per-stage gossip outer step, its checkpoint in the layout of JAX's
``PipelineProgram.state_pytree``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.comm import bytes_model
from repro_torch.comm import payload as payload_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import pairing as pairing_lib
from repro_torch.core.elastic import ElasticContext
from repro_torch.core.noloco import GossipTrainer, TrainerConfig, TrainState
from repro_torch.core.outer import OuterState, StreamSchedule
from repro_torch.core.pairing import Membership
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWState
from repro_torch.pipeline import PipelineTrainer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["GossipProgram", "DistributedProgram", "PipelineProgram"]


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()


class _ElasticSurface:
    """The elastic surface over ``self.elastic`` (an :class:`~repro_torch.
    core.elastic.ElasticContext`, or None for a fixed world, where
    ``membership_epoch`` is None and the loop's telemetry stays silent)."""

    elastic: ElasticContext | None

    @property
    def membership(self) -> Membership | None:
        return None if self.elastic is None else self.elastic.membership

    @property
    def membership_epoch(self) -> int | None:
        return None if self.elastic is None else self.elastic.epoch

    @property
    def partition(self):
        return None if self.elastic is None else self.elastic.partition

    @property
    def round_absent(self) -> frozenset[int]:
        return frozenset() if self.elastic is None else self.elastic.round_absent

    @round_absent.setter
    def round_absent(self, value) -> None:
        self._require_elastic().round_absent = frozenset(value)

    @property
    def last_partner(self) -> np.ndarray | None:
        return None if self.elastic is None else self.elastic.last_partner

    def set_membership(self, membership: Membership) -> None:
        self._require_elastic().set_membership(membership)

    def set_partition(self, groups) -> None:
        """Restrict pairings to partition components (None heals)."""
        self._require_elastic().set_partition(groups)

    def _require_elastic(self) -> ElasticContext:
        if self.elastic is None:
            raise ValueError(f"{type(self).__name__} has no ElasticContext attached; "
                             "construct it with one to drive membership changes")
        return self.elastic


class GossipProgram(_ElasticSurface):
    """Stacked-simulation runtime over :class:`GossipTrainer`.

    ``partners`` records the partner table of every NoLoCo outer step, in
    order."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, *, replicas: int, seed: int = 0,
                 membership: Membership | None = None, elastic: ElasticContext | None = None,
                 device: torch.device | str = "cuda"):
        tcfg.comm.validate()
        if tcfg.comm.streams > 1 and tcfg.outer.method != "noloco":
            raise ValueError("streams > 1 is a noloco-only feature (gossip pairing)")
        if elastic is None:
            elastic = ElasticContext(membership or Membership.full(replicas))
        elif membership is not None:
            raise ValueError("pass membership OR elastic, not both")
        if elastic.world != replicas:
            raise ValueError(f"elastic world {elastic.world} != replicas {replicas}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.replicas = replicas
        self.seed = seed
        self.device = resolve_device(device)
        self.elastic = elastic
        self.partners: list[np.ndarray] = []
        self.trainer = GossipTrainer(
            tcfg, lambda params, batch: model_api.stacked_loss(params, cfg, batch)
        )
        # streaming outer steps: staggered per-stream syncs, for streams > 1
        # or the φ-prefetch overlap (one stream)
        self._streaming = tcfg.outer.method == "noloco" and (
            tcfg.comm.streams > 1 or tcfg.comm.overlap)
        self._schedule = self._partition = self._stream_cost = None
        self._stream_events: list[dict] = []
        self._phi_pre = self._pre_partner = self._pre_epoch = None
        if self._streaming:
            s = tcfg.comm.streams
            self._schedule = StreamSchedule(tcfg.outer.inner_steps, s)
            stacked = tree_map(lambda x: payload_lib.LeafShape((replicas,) + x.shape, x.dtype),
                               bytes_model.abstract_params(cfg))
            self._partition = payload_lib.stream_partition(stacked, s, fuse=tcfg.comm.fuse)
            self._reset_stream_state()

    def initial_params(self) -> PyTree:
        """One replica's starting weights, on the CPU."""
        return model_api.init_params(torch.Generator().manual_seed(self.seed), self.cfg)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _ids(self) -> torch.Tensor:
        return torch.as_tensor(self.elastic.active_ids(), dtype=torch.int64, device=self.device)

    # -- SimCluster's hooks ---------------------------------------------------

    def inner_step_index(self, state: TrainState) -> int:
        return int(state.inner_step)

    def outer_round_index(self, state: TrainState) -> int:
        return int(state.outer.step)

    def sync_due(self, state: TrainState) -> bool:
        if self._streaming:
            return self._schedule.due(int(state.inner_step)) is not None
        return self.trainer.should_sync(state)

    def _reset_stream_state(self) -> None:
        """Nothing pre-sent: every stream's next sync blocks."""
        s = self._schedule.stream_count
        self._phi_pre = None
        self._pre_partner = np.full((s, self.replicas), -1, dtype=np.int64)
        self._pre_epoch = np.full((s,), -1, dtype=np.int64)

    @torch.no_grad()
    def warm_start(self, state: TrainState, replica: int, source: int) -> TrainState:
        """Rejoin surgery: the replica adopts a live peer's slow weights as
        both its φ and its θ, with zero outer momentum, zero AdamW moments and
        a step count of 0.  θ and φ are new tensors (one shared tensor where
        they alias, as right after an outer step), δ too; the donated
        moments are zeroed in place."""
        def adopt(x, p):
            fresh = x.clone()
            fresh[replica] = p[source]
            return fresh

        phis, thetas = [], []
        for th, p in zip(tree_leaves(state.theta), tree_leaves(state.outer.phi)):
            phis.append(adopt(p, p))
            thetas.append(phis[-1] if _same_storage(th, p) else adopt(th, p))
        for m in tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu):
            m[replica].zero_()
        count = state.opt.count.clone()
        count[replica] = 0
        row = torch.tensor([replica], device=self.device)
        return TrainState(
            theta=tree_unflatten(state.theta, thetas),
            opt=AdamWState(mu=state.opt.mu, nu=state.opt.nu, count=count),
            outer=OuterState(phi=tree_unflatten(state.outer.phi, phis),
                             delta=tree_map(lambda d: d.index_fill(0, row, 0), state.outer.delta),
                             step=state.outer.step),
            inner_step=state.inner_step,
        )

    # -- TrainProgram -------------------------------------------------------

    def init_state(self, example_batch: dict) -> TrainState:
        r = self.replicas
        stacked = tree_map(
            lambda p: p.to(self.device).unsqueeze(0).repeat((r,) + (1,) * p.dim()),
            self.initial_params(),
        )
        return self.trainer.init(stacked)

    def inner_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One inner step; frozen replicas (dropped, or not granted a step by
        the asynchronous clock) keep their state, and the reported loss
        covers the active members only."""
        active = self.elastic.active_array()
        if active is None:
            return self.trainer.inner_step(state, self._batch(batch))
        state, metrics = self.trainer.inner_step(
            state, self._batch(batch), active=torch.from_numpy(active).to(self.device))
        return state, dict(metrics, loss=metrics["loss"].index_select(0, self._ids()))

    def _partner_fn(self, key: int):
        seed = self.tcfg.outer.seed
        return lambda parts: pairing_lib.elastic_partner_table(
            key, parts, seed=seed, groups=self.elastic.partition)

    def _outer(self, state: TrainState, partner, active, staleness=None) -> TrainState:
        if self.tcfg.outer.method == "noloco":
            self.partners.append(partner)
        to_dev = lambda a: None if a is None else torch.as_tensor(a, device=self.device)
        return self.trainer.outer_step(state, partner=partner, active=to_dev(active),
                                       staleness=to_dev(staleness))

    def maybe_outer_step(self, state: TrainState) -> tuple[TrainState, bool]:
        if self._streaming:
            return self._maybe_stream_sync(state)
        if not self.trainer.should_sync(state):
            return state, False
        noloco = self.tcfg.outer.method == "noloco"
        plan = self.elastic.plan_round(self._partner_fn(state.outer.step) if noloco else None)
        return self._outer(state, plan.partner, plan.active), True

    def outer_step_async(self, state: TrainState, *, sync_index: int, due,
                         staleness) -> tuple[TrainState, bool]:
        """One merged sync tick of the asynchronous clock.  The pairing is
        drawn over all round participants at key ``sync_index`` (the merged
        tick), so non-due participants are passive sources; only ``due``
        replicas apply the update.  Under ``stale="momentum"`` each Δ on the
        wire is discounted by its staleness.  With everyone due and nobody
        late it is the synchronous call itself."""
        if self.tcfg.outer.method != "noloco":
            raise ValueError("asynchronous merged-tick sync is NoLoCo-only")
        plan = self.elastic.plan_round(self._partner_fn(sync_index))
        if plan.all_absent:   # every member in straggle debt: a frozen round
            return self._outer(state, plan.partner, plan.active), True
        update = np.asarray(due, dtype=bool).copy()
        tau = np.asarray(staleness)
        if plan.active is not None:
            update &= np.asarray(plan.active, dtype=bool)
        if update.all() and not tau.any():
            return self._outer(state, plan.partner, None), True
        stale = None
        if self.tcfg.outer.stale == "momentum" and tau.any():
            stale = tau.astype(np.float32)
        return self._outer(state, plan.partner, update, stale), True

    def _maybe_stream_sync(self, state: TrainState) -> tuple[TrainState, bool]:
        """One stream's staggered sync.  The global sync index ``i`` (the
        stream syncs so far, which ``OuterState.step`` counts) is the
        pairing key; the stream's next sync is ``i + streams``, the key its
        φ′ pre-send travels on, drawn over the membership.  The prefetch is
        consumed only when it was sent under this membership epoch along
        this round's actual table; otherwise this stream alone blocks on
        (Δ, φ) (an epoch fallback)."""
        t = int(state.inner_step)
        k = self._schedule.due(t)
        if k is None:
            return state, False
        i = self._schedule.sync_index(k, t)
        seed = self.tcfg.outer.seed
        overlap = self.tcfg.comm.overlap
        plan = self.elastic.plan_round(self._partner_fn(i))
        had_prefetch = self._pre_epoch[k] >= 0
        consume = bool(overlap and self._phi_pre is not None
                       and self._pre_epoch[k] == self.elastic.epoch
                       and np.array_equal(self._pre_partner[k], np.asarray(plan.partner)))
        next_table = None
        if overlap:
            next_table = pairing_lib.elastic_partner_table(
                i + self._schedule.stream_count, self.elastic.membership, seed=seed,
                groups=self.elastic.partition)
        self.partners.append(plan.partner)
        active = None if plan.active is None else torch.from_numpy(
            np.asarray(plan.active, dtype=bool)).to(self.device)
        state, phi_pre_out = self.trainer.outer_step_stream(
            state, stream=k, partition=self._partition, partner=plan.partner, active=active,
            phi_pre=self._phi_pre, consume_prefetch=consume, partner_next=next_table)
        if phi_pre_out is not None:
            self._phi_pre = phi_pre_out
            self._pre_partner[k] = np.asarray(next_table)
            self._pre_epoch[k] = self.elastic.epoch
        cost = self._cost_for_streams()
        sc = cost.per_stream[k] if cost else None
        payload = sc.payload_bytes if sc else 0
        blocking = sc.blocking_bytes if (sc and consume) else payload
        self._stream_events.append({
            "stream": k,
            "offset": self._schedule.offsets[k],
            "sync_index": i,
            "payload_bytes": payload,
            "blocking_bytes": blocking,
            "overlapped_bytes": payload - blocking,
            "blocked": not consume,
            "epoch_fallback": bool(overlap and not consume and had_prefetch),
        })
        return state, True

    def _cost_for_streams(self):
        if self._stream_cost is None:
            self._stream_cost = self.comm_cost()
        return self._stream_cost

    def drain_stream_events(self) -> list[dict]:
        """The ``stream_sync`` records since the last drain."""
        events, self._stream_events = self._stream_events, []
        return events

    def eval_step(self, state: TrainState, batch: dict) -> float:
        losses = self.trainer.eval_loss(state.theta, self._batch(batch))
        return float(losses.index_select(0, self._ids()).mean())

    def weight_std(self, state: TrainState) -> float:
        """Cross-replica weight std over the active replicas (a dropped
        replica's stale weights are not part of the ensemble)."""
        if self.elastic.membership.num_active < 2:
            return 0.0
        theta = state.theta
        if not self.elastic.is_full:
            ids = self._ids()
            theta = tree_map(lambda x: x.index_select(0, ids), theta)
        return float(metrics_lib.replica_weight_std(theta))

    def state_pytree(self, state: TrainState) -> dict:
        stream = None
        if self._streaming:
            # the prefetched φ and the (pairing, epoch) it was pre-sent along,
            # so a resumed run makes the same consume-or-fall-back decisions
            stream = {"pre_partner": self._pre_partner.copy(),
                      "pre_epoch": self._pre_epoch.copy()}
            if self._phi_pre is not None:
                stream["phi_pre"] = self._phi_pre
        return convert.train_state_to_numpy(state, membership=self.elastic.state_dict(),
                                            stream=stream)

    def load_state_pytree(self, state: TrainState, tree: dict) -> TrainState:
        """The state of a checkpoint in the JAX layout (the stacked
        runtime's, or the distributed runtime's, whose replicas' rows make
        the stacked state), its membership and
        partition restored into the elastic context and, when streaming,
        its in-flight ``stream`` state (a checkpoint without one: nothing
        pre-sent, so every stream's next sync blocks)."""
        if "outer" not in tree and "phi" in tree:   # the distributed runtime's layout
            tree = convert.gossip_tree_from_distributed(tree)
        mem = tree.get("membership")
        if mem is not None:
            mask = np.asarray(mem["mask"], dtype=bool)
            if mask.shape != (self.replicas,):
                raise ValueError(f"checkpoint holds {mask.shape[0]} replicas, this run {self.replicas}")
            self.elastic.load_state_dict(mem)
        if self._streaming:
            self._reset_stream_state()
            st = tree.get("stream")
            if st is not None:
                self._pre_partner = np.asarray(st["pre_partner"]).astype(np.int64)
                self._pre_epoch = np.asarray(st["pre_epoch"]).astype(np.int64)
                if st.get("phi_pre") is not None:
                    self._phi_pre = convert.stacked_params_from_jax_numpy(
                        st["phi_pre"], self.cfg, device=self.device)
        return convert.train_state_from_jax_numpy(tree, self.cfg, device=self.device)

    def comm_cost(self):
        method = self.tcfg.outer.method
        if method == "none":  # also the fsdp baseline, whose outer step is "none"
            return None
        return bytes_model.outer_step_cost(
            bytes_model.abstract_params(self.cfg), self.tcfg.comm, method=method,
            world=self.replicas,
        )


class DistributedProgram(_ElasticSurface):
    """Replica-group runtime over a configured ``DistributedTrainer``: this
    rank's replica.

    Every rank runs the loop; only rank 0 writes telemetry and checkpoints
    (the loop reads ``rank`` and calls ``barrier`` after a save), whole
    replicas in either case: with a model or a data axis the shards are
    gathered before a save and cut again from a loaded tree.  The
    per-step loss the loop sees is this rank's replica's (NaN in a step it
    sits out); eval and the weight std cover the active replicas.

    Elasticity: the trainer's :class:`~repro_torch.core.elastic.
    ElasticContext` (when attached) is surfaced as the stacked program's,
    with the hooks :class:`~repro_torch.sim.SimCluster` drives; every rank
    runs its own ``SimCluster`` from the same plan.  The checkpoint is
    JAX's ``DistributedProgram.state_pytree`` tree, membership and the
    streams' in-flight state included, so resuming after churn, mid-async
    or mid-stream continues the trajectory exactly."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.group = trainer.group
        self.rank = trainer.group.rank
        self.replicas = trainer.plan.replicas
        self.replica = trainer.plan.replica_of(self.rank)
        self.elastic = trainer.elastic

    def _rows(self, batch: dict) -> dict:
        """This replica's rows of a stacked (R, B, S) batch: the rows the
        reference's ``_to_global`` gives replica r."""
        r = self.replica
        return {k: torch.from_numpy(np.ascontiguousarray(v[r:r + 1])).to(self.group.device)
                for k, v in batch.items()}

    def barrier(self) -> None:
        self.group.barrier()

    # -- SimCluster's hooks ---------------------------------------------------

    def inner_step_index(self, state: dict) -> int:
        return int(state["inner_step"])

    def outer_round_index(self, state: dict) -> int:
        """The pairing key of the round due at this step: a stream's global
        sync index when streaming, else the 0-indexed round."""
        return self.trainer.round_index(int(state["inner_step"]))

    def sync_due(self, state: dict) -> bool:
        return self.trainer.sync_due(int(state["inner_step"]))

    def warm_start(self, state: dict, replica: int, source: int) -> dict:
        """Rejoin over the group: one send of the source's φ to the
        rejoining rank, the only traffic a rejoin costs."""
        return self.trainer.warm_start(state, replica, source)

    def drain_recompile_events(self) -> list[dict]:
        events, self.trainer.recompile_events = self.trainer.recompile_events, []
        return events

    def drain_stream_events(self) -> list[dict]:
        events, self.trainer.stream_events = self.trainer.stream_events, []
        return events

    def pool_stats(self) -> dict:
        return self.trainer.pool.stats()

    def _active_ids(self) -> list[int] | None:
        if self.elastic is None or self.elastic.is_full:
            return None
        return list(self.elastic.active_ids())

    # -- TrainProgram -------------------------------------------------------

    def init_state(self, example_batch: dict) -> dict:
        return self.trainer.init_state(self._rows(example_batch))

    def inner_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        return self.trainer.inner_step(state, self._rows(batch))

    def maybe_outer_step(self, state: dict) -> tuple[dict, bool]:
        return self.trainer.maybe_outer_step(state)

    def outer_step_async(self, state: dict, *, sync_index: int, due, staleness):
        return self.trainer.outer_step_async(state, sync_index=sync_index, due=due,
                                             staleness=staleness)

    def finish(self, state: dict) -> dict:
        """The run's end: the pre-sends in flight are waited."""
        return self.trainer.finish(state)

    def eval_step(self, state: dict, batch: dict) -> float:
        """Mean over the active replicas of their grad-free losses: rank 0
        gathers the (R,) losses, means them and broadcasts the mean."""
        rows = self.group.gather_rows(self.trainer.eval_loss(state, self._rows(batch)).float())
        mean = None
        if rows is not None:
            losses = rows.reshape(-1)
            ids = self._active_ids()
            if ids is not None:
                losses = losses[ids]
            mean = float(losses.mean())
        return self.group.broadcast_object(mean)

    def _gather_tree(self, tree: PyTree) -> PyTree | None:
        """Rank 0: the replicas' rows of a (1, ...)-leaved tree as one
        stacked (R, ...) tree on the CPU, gathered one packed buffer per
        dtype; the other ranks: None.  With a model or a data axis each
        replica's shards are put together first (over data, then over
        model), and only the ranks at data and model index 0 gather the
        replicas' rows (each (data, model) place has its own replica
        subgroup), so a checkpoint does not depend on the plan."""
        buffers, spec = payload_lib.pack(self.trainer.gather(tree), lead=1)
        if self.group.model_index or self.group.data_index:
            return None
        rows = [self.group.gather_rows(b[0]) for b in buffers]
        return None if self.rank else payload_lib.unpack(rows, spec)

    def weight_std(self, state: dict) -> float:
        """Cross-replica weight std over the active replicas; 0.0 below two
        (every rank knows the membership, so none gathers then)."""
        ids = self._active_ids()
        if ids is not None and len(ids) < 2:
            return 0.0
        stacked = self._gather_tree(state["theta"])
        std = None
        if stacked is not None:
            if ids is not None:
                stacked = tree_map(lambda x: x[ids], stacked)
            stacked = tree_map(lambda x: x.to(self.group.device), stacked)
            std = float(metrics_lib.replica_weight_std(stacked))
        return self.group.broadcast_object(std)

    def state_pytree(self, state: dict) -> dict | None:
        """Rank 0: JAX's ``DistributedProgram.state_pytree`` tree with host
        leaves, every replica's rows gathered (``phi_pre`` after the
        pre-sends in flight are waited), the streams' ``pre_partner`` /
        ``pre_epoch`` and the membership; the other ranks: None."""
        tr = self.trainer
        keys = [("theta", state["theta"]), ("mu", state["opt"].mu), ("nu", state["opt"].nu),
                ("phi", state["phi"]), ("delta", state["delta"])]
        if "phi_pre" in state:
            keys.append(("phi_pre", tr.settled(state)["phi_pre"]))
        trees = {k: self._gather_tree(v) for k, v in keys}
        count = self.group.gather_rows(state["opt"].count.to(torch.int32))
        step = self.group.gather_rows(torch.tensor([state["outer_step"]], dtype=torch.int32))
        if self.rank:
            return None
        host = lambda t: tree_map(convert.to_host, t)
        tree = {"theta": host(trees["theta"]),
                "opt": {"mu": host(trees["mu"]), "nu": host(trees["nu"]),
                        "count": count.reshape(-1).numpy()},
                "phi": host(trees["phi"]), "delta": host(trees["delta"]),
                "outer_step": step.reshape(-1).numpy(),
                "inner_step": np.int64(state["inner_step"])}
        if "phi_pre" in trees:
            tree["phi_pre"] = host(trees["phi_pre"])
        if tr.streaming:
            tree["stream"] = tr.stream_state()
        if self.elastic is not None:
            tree["membership"] = self.elastic.state_dict()
        return tree

    def load_state_pytree(self, state: dict, tree: dict) -> dict:
        """This replica's row of a checkpoint in JAX's ``DistributedProgram``
        layout (a stacked runtime's checkpoint is not one: its counters
        differ in shape), its membership into the elastic context.  With
        streams, a checkpoint written without them bootstraps: nothing was
        pre-sent (every stream's next sync blocks), and ``phi_pre`` is the
        restored φ."""
        tr = self.trainer
        if "membership" in tree and self.elastic is not None:
            self.elastic.load_state_dict(tree["membership"])
        r, cfg, dev = self.replica, tr.cfg, self.group.device
        row = lambda t: tree_map(lambda a: a[r:r + 1], t)
        counts = np.asarray(tree["opt"]["count"]).astype(np.int32)
        world = counts.shape[0]
        if world != self.replicas:
            raise ValueError(f"checkpoint holds {world} replicas, this run {self.replicas}")
        params = lambda t, dtype=None: tr.shard(convert.stacked_params_from_jax_numpy(
            row(t), cfg, device=dev, dtype=dtype))
        new = dict(
            state,
            theta=params(tree["theta"]),
            opt=AdamWState(mu=params(tree["opt"]["mu"], torch.float32),
                           nu=params(tree["opt"]["nu"], torch.float32),
                           count=torch.from_numpy(counts[r:r + 1].copy()).to(dev)),
            phi=params(tree["phi"]), delta=params(tree["delta"]),
            outer_step=int(np.asarray(tree["outer_step"]).reshape(-1)[r]),
            inner_step=int(tree["inner_step"]),
        )
        tr.load_stream_state(tree.get("stream"))
        if "phi_pre" in tree:
            new["phi_pre"] = params(tree["phi_pre"])
        elif "phi_pre" in state:
            new["phi_pre"] = tree_map(torch.clone, new["phi"])
        return new

    def comm_cost(self):
        method = self.trainer.outer_cfg.method
        if method == "none":
            return None
        return bytes_model.outer_step_cost(
            bytes_model.abstract_params(self.trainer.cfg), self.trainer.comm_cfg,
            method=method, world=self.replicas)


class PipelineProgram(_ElasticSurface):
    """Routed-pipeline runtime: §3.1 routing and the per-stage §3.2 gossip
    over :class:`~repro_torch.pipeline.PipelineTrainer`.  With an elastic
    context, routes and every stage's pairing cover the active replicas
    only; the others are frozen and carry no routed traffic."""

    def __init__(self, trainer: PipelineTrainer):
        self.trainer = trainer
        self.replicas = trainer.replicas
        self.elastic = trainer.elastic

    def init_state(self, example_batch: dict) -> dict:
        return self.trainer.init()

    def inner_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        state, loss = self.trainer.train_step(state, batch)
        return state, {"loss": torch.tensor(loss)}

    def maybe_outer_step(self, state: dict) -> tuple[dict, bool]:
        return self.trainer.maybe_outer_step(state)

    def eval_step(self, state: dict, batch: dict) -> float:
        return float(self.trainer.eval_loss(state["params"], batch))

    def weight_std(self, state: dict) -> float:
        return self.trainer.weight_std(state)

    def state_pytree(self, state: dict) -> dict:
        return convert.pipeline_state_to_numpy(
            state, membership=None if self.elastic is None else self.elastic.state_dict())

    def load_state_pytree(self, state: dict, tree: dict) -> dict:
        """The state of a checkpoint in the JAX layout.  Resuming gossip
        from a ``method="none"`` checkpoint warm-starts the outer state:
        φ is the restored θ, δ zero, and the outer counter ``step // m``,
        so the next sync fires at the next multiple of m."""
        tr = self.trainer
        if "membership" in tree and self.elastic is not None:
            self.elastic.load_state_dict(tree["membership"])
        new = convert.pipeline_state_from_jax_numpy(tree, tr.cfg, tr.num_stages,
                                                    device=tr.device)
        if "outer" not in new and "outer" in state:
            new["outer"] = {"phi": [tree_map(lambda t: t.clone(), p) for p in new["params"]],
                            "delta": [tree_map(torch.zeros_like, p) for p in new["params"]],
                            "step": new["step"] // tr.outer.inner_steps}
        return new

    def comm_cost(self):
        """One replica's payload is all of its stages' parameters."""
        tr = self.trainer
        if not tr.outer_enabled:
            return None
        one = {f"stage{s}": bytes_model.abstract_stage_params(tr.cfg, s, tr.num_stages)
               for s in range(tr.num_stages)}
        return bytes_model.outer_step_cost(one, tr.comm, method=tr.outer.method,
                                           world=tr.replicas)
