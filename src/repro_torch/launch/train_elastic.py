"""Elastic-gossip training CLI of the port: the stacked runtime under a fault
plan (the port of ``repro/launch/train_elastic.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_elastic \\
        --arch paper-small-125m --replicas 8 --batch 2 --seq 1024 --steps 50 \\
        --inner-steps 5 --fault-plan plan.json --eval-every 5

    # reduced config on the CPU (plain PyTorch attention and outer update):
    PYTHONPATH=src python -m repro_torch.launch.train_elastic --device cpu \\
        --reduced --replicas 8 --steps 25 --inner-steps 5 --seq 32 --batch 2 \\
        --fault-plan plan.json --eval-every 10

``plan.json`` is a :class:`repro_torch.sim.FaultPlan` (drop, rejoin with a
warm start, straggle, rate, partition, heal; see that module for the
schema), replayed deterministically against the production gossip outer
step.  A ``rate`` event puts replicas on their own round clocks
(``--async-clock`` forces a rate-1 asynchronous world, bit-identical to
the synchronous run); ``--stale`` picks the stale-Δ rule.  Without
``--fault-plan`` this is a healthy run of the same program.  ``--device``
defaults to ``cuda`` and raises without a GPU; on the card every inner
step runs the flash pair and every round the NoLoCo update kernel.
``--stream-count`` above 1 syncs the payload in that many staggered streams
with the §3.2 φ-prefetch, which composes with churn through the
membership-epoch fallback.
The last stdout line is the JAX CLI's summary JSON plus ``device``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any

import torch

from repro_torch.comm import CommConfig
from repro_torch.configs import registry
from repro_torch.core.elastic import ELASTIC_METHODS
from repro_torch.data import LoaderConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import method_config
from repro_torch.models.config import ModelConfig
from repro_torch.sim import FaultPlan, SimCluster
from repro_torch.train import GossipProgram, LoopConfig, make_loop


def run_elastic_training(
    cfg: ModelConfig,
    plan: FaultPlan,
    *,
    method: str = "noloco",
    replicas: int = 8,
    per_replica_batch: int = 2,
    seq_len: int = 64,
    steps: int = 50,
    total_steps: int | None = None,
    inner_lr: float = 3e-3,
    inner_steps: int = 5,
    eval_every: int = 0,
    eval_batches: int = 2,
    seed: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    resume: bool = False,
    log: bool = False,
    log_jsonl: str | None = None,
    codec: str = "none",
    stream_count: int = 1,
    overlap: bool | None = None,
    reassign_data: bool = False,
    stale: str = "naive",
    async_clock: bool | None = None,
    device: str = "cuda",
) -> dict[str, Any]:
    """Train under ``plan``; returns the engine's result dict plus
    ``rounds`` (the simulator's per-round participation history),
    ``fault_history`` and the final ``membership``, as the JAX package's
    ``run_elastic_training`` does, and ``partners`` (every NoLoCo round's
    table).  The JAX function's ``impl``/``interpret`` pick its kernels;
    the port's follow the device.

    ``reassign_data`` redistributes dropped replicas' loader streams over
    survivors; ``async_clock`` gives each replica its own round clock (on
    whenever the plan has rate events), ``stale`` the stale-Δ rule
    (``"naive"`` / ``"momentum"``).  ``stream_count`` partitions the outer
    payload into staggered streams; ``overlap`` adds the §3.2 φ-prefetch
    (on by default when ``stream_count > 1``) and composes with churn
    through the membership-epoch fallback: a stream whose pre-send pairing
    went stale blocks once, the others stay overlapped."""
    dev = resolve_device(device)
    if overlap is None:
        overlap = stream_count > 1
    horizon = total_steps or steps
    tcfg = method_config(
        method, inner_lr=inner_lr, total_steps=horizon, warmup=max(horizon // 10, 1),
        inner_steps=inner_steps, seed=seed,
        comm=CommConfig(codec=codec, streams=stream_count, overlap=overlap), stale=stale,
    )
    program = GossipProgram(cfg, tcfg, replicas=replicas, seed=seed, device=dev)
    sim = SimCluster(program, plan, reassign_data=reassign_data, async_clock=async_clock)
    loop = make_loop(
        sim,
        LoaderConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                     per_replica_batch=per_replica_batch, replicas=replicas, seed=seed),
        LoopConfig(steps=steps, eval_every=eval_every, seed=seed, ckpt_dir=ckpt_dir,
                   ckpt_every=ckpt_every, resume=resume, log_jsonl=log_jsonl, log=log,
                   run_name=f"{cfg.name}-elastic"),
        n_eval=eval_batches,
    )
    res = loop.run()
    res["rounds"] = sim.rounds()
    res["fault_history"] = sim.history
    res["membership"] = {"epoch": sim.membership.epoch,
                         "active": list(sim.membership.active_ids)}
    res["partners"] = list(program.partners)
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-small-125m")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the arch")
    ap.add_argument("--method", default="noloco", choices=list(ELASTIC_METHODS))
    ap.add_argument("--fault-plan", default=None,
                    help="JSON FaultPlan (repro_torch.sim.faults); omit for a healthy run")
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--total-steps", type=int, default=None,
                    help="LR-schedule horizon (pin it for interrupted runs that will resume; "
                         "default: --steps)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--inner-steps", type=int, default=5)
    ap.add_argument("--codec", default="none", choices=["none", "fp16", "bf16", "int8"])
    ap.add_argument("--stream-count", type=int, default=1,
                    help="streaming outer steps: partition the payload into N "
                         "streams synced on staggered round offsets "
                         "(implies the §3.2 overlap when > 1)")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reassign-data", action="store_true",
                    help="redistribute dropped replicas' loader streams over survivors "
                         "(default: skip them)")
    ap.add_argument("--stale", default="naive", choices=["naive", "momentum"],
                    help="async stale-Δ rule: naive applies a delayed Δ as-is, momentum "
                         "discounts it by 1/(1+τ)")
    ap.add_argument("--async-clock", action="store_true", default=None,
                    help="per-replica round clocks (on when the fault plan has rate events)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (the JAX package's format)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save every N steps (0: only a final save)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint under --ckpt-dir")
    ap.add_argument("--log-jsonl", default=None,
                    help="append one JSON telemetry event per line to this file")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device to train on (default cuda; cpu runs the plain versions)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=min(cfg.vocab_size, 512), remat=False, dtype="float32")
    plan = FaultPlan.load(args.fault_plan) if args.fault_plan else FaultPlan()
    horizon = plan.max_effect_step(args.inner_steps)
    if horizon > args.steps:
        print(f"warning: fault-plan effects extend to step {horizon}, beyond --steps "
              f"{args.steps}; in-flight straggle debts ride the checkpoint and resume exactly",
              flush=True)
    res = run_elastic_training(
        cfg, plan, method=args.method, replicas=args.replicas, per_replica_batch=args.batch,
        seq_len=args.seq, steps=args.steps, total_steps=args.total_steps, inner_lr=args.lr,
        inner_steps=args.inner_steps, eval_every=args.eval_every, seed=args.seed,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, resume=args.resume, log=True,
        log_jsonl=args.log_jsonl, codec=args.codec, stream_count=args.stream_count,
        reassign_data=args.reassign_data, stale=args.stale, async_clock=args.async_clock,
        device=args.device,
    )
    summary = {
        "arch": cfg.name, "method": args.method, "fault_events": len(plan.events),
        "outer_syncs": res["outer_syncs"], "stream_count": res.get("stream_count", 1),
        "blocking_fraction": round(res["blocking_fraction"], 4),
        "membership": res["membership"],
        "final_train_loss": res["losses"][-1] if res["losses"] else None,
        "final_eval": res["evals"][-1][1] if res["evals"] else None,
        "final_weight_std": res["final_weight_std"],
        "wall_s": round(res["wall_s"], 1),
    }
    if "max_staleness" in res:
        summary["max_staleness"] = res["max_staleness"]
        summary["blocked_syncs"] = res["blocked_syncs"]
    summary["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(summary))
    if args.out:
        res.pop("state")
        res["partners"] = [p.tolist() for p in res["partners"]]
        with open(args.out, "w") as f:
            json.dump(res, f)
    return summary


if __name__ == "__main__":
    main()
