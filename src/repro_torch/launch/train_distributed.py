"""Distributed NoLoCo training over ``torch.distributed``: one rank per
replica, each holding its replica on its own device.

The port of ``repro/launch/train_distributed.py`` for a fixed world.
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

    # four ranks sharing one card, the payload staged through host memory:
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --data 4 \\
        --batch-per-replica 4 --seq 1024 --steps 10 --inner-steps 5 --backend gloo

    # one rank per card, NCCL between them:
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --data 4 --backend nccl

    # the reduced model on four CPU processes:
    PYTHONPATH=src python -m repro_torch.launch.train_distributed --device cpu \\
        --backend gloo --reduced --data 4 --steps 8 --inner-steps 4 --seq 32

The launcher spawns ``--data`` ranks with a ``file://`` rendezvous in a
temporary directory; under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set)
each process is one rank instead.  ``--device`` defaults to ``cuda`` and
raises without a GPU; ``--backend nccl`` with more ranks than cards
raises and names ``--backend gloo``.  The last stdout line is the JAX
CLI's summary JSON plus ``method``, ``device`` and ``backend``.

Not on this path yet, each refused by name: ``--model > 1`` (ROADMAP
Queue 1 item 9c, the model axis); ``--fault-plan``, ``--reassign-data``,
``--stale momentum``, ``--overlap`` and ``--stream-count > 1`` (item 9b,
elastic, asynchronous and streamed rounds on the replica group).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch.comm import CommConfig
from repro_torch.comm import payload as payload_lib
from repro_torch.comm import bytes_model
from repro_torch.configs import registry
from repro_torch.core.outer import OuterConfig
from repro_torch.data import LoaderConfig
from repro_torch.launch import mesh
from repro_torch.models import model as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import plans as plans_lib
from repro_torch.parallel import steps as steps_lib
from repro_torch.parallel.steps import ELASTIC_ITEM
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["DistributedTrainer", "build_parser", "check_args", "run_rank", "main"]


@dataclasses.dataclass
class DistributedTrainer:
    """The step functions and this rank's replica state.

    State: ``{"theta", "opt", "phi", "delta"}`` trees with a leading axis
    of 1 (this rank's replica), ``"outer_step"`` and ``"inner_step"``
    ints.  ``partners`` records the partner table of every NoLoCo round."""

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

    def __post_init__(self):
        self.outer_cfg.validate()
        self.comm_cfg.validate()
        if self.plan.world != self.group.world:
            raise ValueError(f"plan needs {self.plan.world} ranks, the group has "
                             f"{self.group.world}")
        if self.comm_cfg.streams > 1 or self.comm_cfg.overlap:
            raise NotImplementedError(f"streamed outer steps and the φ-prefetch overlap on the "
                                      f"replica group come with {ELASTIC_ITEM}")
        if self.outer_cfg.stale != "naive":
            raise NotImplementedError(f"the stale-Δ rule of asynchronous rounds comes with "
                                      f"{ELASTIC_ITEM}")
        self.device = self.group.device
        self.partners: list[np.ndarray] = []

    def initial_params(self) -> PyTree:
        """One replica's starting weights, on the CPU: every replica starts
        from the same point, drawn from ``seed`` as the stacked runtime
        draws it."""
        return model_api.init_params(torch.Generator().manual_seed(self.seed), self.cfg)

    def init_state(self, batch_example: dict | None = None) -> dict:
        theta = tree_map(lambda p: p.to(self.device).unsqueeze(0).contiguous(),
                         self.initial_params())
        self.bundle = steps_lib.build_train_step(self.cfg, self.plan, self.group,
                                                 self.inner_cfg, data_sync=self.data_sync)
        self.pool = steps_lib.OuterProgramPool(
            self.plan, self.outer_cfg, group=self.group, comm_cfg=self.comm_cfg,
            schedule=self.schedule, pairing_pool=self.pairing_pool, seed=self.seed)
        return {"theta": theta, "opt": steps_lib.init_opt_state(theta),
                "phi": tree_map(torch.clone, theta), "delta": tree_map(torch.zeros_like, theta),
                "outer_step": 0, "inner_step": 0}

    def inner_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One AdamW step of this rank's replica on its (1, B, S) batch."""
        theta, opt, metrics = self.bundle.step_fn(state["theta"], state["opt"], batch)
        return dict(state, theta=theta, opt=opt, inner_step=state["inner_step"] + 1), metrics

    def outer_index(self, state: dict) -> int:
        """The round the next outer step runs (0-indexed)."""
        return state["inner_step"] // self.outer_cfg.inner_steps - 1

    def maybe_outer_step(self, state: dict) -> tuple[dict, bool]:
        if state["inner_step"] % self.outer_cfg.inner_steps:
            return state, False
        outer_index = self.outer_index(state)
        fn = self.pool.program(outer_index)
        if self.outer_cfg.method == "noloco":
            _, pairs = self.pool.pairs_for(outer_index)
            self.partners.append(np.asarray([d for _, d in pairs], dtype=np.int64))
        theta, phi, delta, step = fn(state["theta"], state["phi"], state["delta"],
                                     state["outer_step"])
        return dict(state, theta=theta, phi=phi, delta=delta, outer_step=step), True

    def eval_loss(self, state: dict, batch: dict) -> torch.Tensor:
        """Grad-free loss of this rank's replica, (1,)."""
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
    ap.add_argument("--overlap", action="store_true", help="§3.2 φ-prefetch (not yet here)")
    ap.add_argument("--stream-count", type=int, default=1,
                    help="streaming outer steps (not yet here)")
    ap.add_argument("--fault-plan", default=None, help="elastic fault plan (not yet here)")
    ap.add_argument("--reassign-data", action="store_true", help="(not yet here)")
    ap.add_argument("--stale", default="naive", choices=["naive", "momentum"],
                    help="async stale-Δ rule (momentum: not yet here)")
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
    """Refuse, by name, what this path does not run yet."""
    if args.model != 1:
        plans_lib.make_plan("gossip_dp", args.data, args.model)   # raises, naming item 9c
    deferred = [flag for flag, on in (
        ("--fault-plan", args.fault_plan is not None), ("--reassign-data", args.reassign_data),
        ("--stale momentum", args.stale != "naive"), ("--overlap", args.overlap),
        ("--stream-count > 1", args.stream_count > 1)) if on]
    if deferred:
        raise NotImplementedError(f"{', '.join(deferred)}: comes with {ELASTIC_ITEM}")


def model_config(args: argparse.Namespace) -> ModelConfig:
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=min(cfg.vocab_size, 512), remat=False, dtype="float32")
    return cfg


def make_trainer(args: argparse.Namespace, group, cfg: ModelConfig | None = None
                 ) -> DistributedTrainer:
    """The rank's trainer for the CLI's flags: the reference's inner AdamW
    (constant lr, no weight decay, clipping at 1) and the paper's outer
    settings (NoLoCo α 0.5, DiLoCo α 0.3, β 0.7)."""
    method = "none" if args.method == "fsdp" else args.method
    alpha = 0.3 if method == "diloco" else 0.5
    inner_steps = args.inner_steps if method != "none" else 10**9
    return DistributedTrainer(
        cfg=cfg or model_config(args), group=group,
        plan=plans_lib.make_plan("gossip_dp", args.data, args.model),
        outer_cfg=OuterConfig(method=method, alpha=alpha, beta=0.7, inner_steps=inner_steps,
                              stale=args.stale),
        inner_cfg=AdamWConfig(lr=args.lr, weight_decay=0.0),
        comm_cfg=CommConfig(codec=args.codec, fuse=not args.no_fuse),
        pairing_pool=args.pairing_pool, schedule=args.schedule, seed=args.seed,
        data_sync=args.method == "fsdp")


def run_rank(group, args: argparse.Namespace, *, trainer: DistributedTrainer | None = None
             ) -> dict:
    """One rank's run of the CLI: the loop over this rank's replica.
    Returns ``{"result": the loop's result (this rank's losses), "trainer",
    "losses": every rank's per-step losses (rank 0), "summary": the CLI's
    summary (rank 0, else None)}``."""
    from repro_torch.train import DistributedProgram, LoopConfig, make_loop

    trainer = trainer or make_trainer(args, group)
    cfg = trainer.cfg
    program = DistributedProgram(trainer)
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
        per_step = np.asarray(losses, dtype=np.float64).mean(0) if res["losses"] else []
        pool = trainer.pool.stats()
        dev = group.device
        summary = {
            "arch": cfg.name, "method": args.method, "replicas": trainer.plan.replicas,
            "tp": trainer.plan.tp, "codec": args.codec, "fuse": not args.no_fuse,
            "overlap": False, "stream_count": 1,
            "blocking_fraction": round(res["blocking_fraction"], 4),
            "final_loss": float(per_step[-1]) if len(per_step) else None,
            "final_eval": res["evals"][-1][1] if res["evals"] else None,
            "tokens_per_s": round(res["tokens_per_s"], 1),
            "comm_bytes": res["comm_bytes"], "wall_s": round(res["wall_s"], 1),
            "pool": pool, "recompiles": pool["misses"],
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "backend": group.backend,
        }
    return {"result": res, "trainer": trainer, "losses": losses, "summary": summary}


def _spawned(group, argv: dict) -> dict:
    """The spawned rank's entry: the picklable part of :func:`run_rank`."""
    out = run_rank(group, argparse.Namespace(**argv))
    return {"summary": out["summary"], "losses": out["losses"],
            "partners": [p.tolist() for p in out["trainer"].partners]}


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    check_args(args)
    env = mesh.from_env()
    if env is not None:   # torchrun: this process is one rank
        rank, world = env
        if world != args.data:
            raise SystemExit(f"--data {args.data} but torchrun started {world} ranks")
        group = mesh.init_replica_group(world, args.backend, args.device, rank=rank)
        try:
            out = _spawned(group, vars(args))
        finally:
            torch.distributed.destroy_process_group()
        if rank:
            return {}
    else:
        out = mesh.spawn(_spawned, args.data, (vars(args),), backend=args.backend,
                         device=args.device)[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"losses": out["losses"], "partners": out["partners"]}, f)
    print(json.dumps(out["summary"]))
    return out["summary"]


if __name__ == "__main__":
    main()
