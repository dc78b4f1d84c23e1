"""Stacked-simulation training CLI of the port, a thin shell over the engine.

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-small-125m \
        --method noloco --replicas 4 --batch 4 --seq 1024 --steps 100

    # int8 wire, checkpoints every 5 steps, then resume to step 20:
    PYTHONPATH=src python -m repro_torch.launch.train --codec int8 \
        --seq 1024 --inner-steps 5 --steps 10 --ckpt-dir D --ckpt-every 5
    PYTHONPATH=src python -m repro_torch.launch.train --codec int8 \
        --seq 1024 --inner-steps 5 --steps 20 --ckpt-dir D --resume

    # reduced config on the CPU (plain PyTorch attention and outer update):
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
        --steps 20 --inner-steps 10 --seq 32 --batch 2 --eval-every 0

Replicas are a stacked leading axis on one device.  The full NoLoCo machinery
runs as in the paper: inner AdamW, the gossip outer step with random
pairings, weight-std tracking.  ``--method`` selects noloco / diloco / fsdp
(gradient mean every step) / none (independent runs); ``--codec`` the
gossip wire (none, fp16, bf16, int8).  ``--arch`` takes the paper models,
qwen3-0.6b and the recurrent families mamba2-370m and recurrentgemma-9b.
On the card the attention forward and backward, the SSD and RG-LRU scans
forward and backward, the NoLoCo outer update and the int8 codec run the
hand-written CUDA kernels; ``--device`` defaults to ``cuda`` and raises
without a GPU.  ``--reduced`` trains the smoke variant of the arch (two
layers, fp32, no remat); without it the published config trains in its own
dtype (recurrentgemma-9b at full depth needs more than one card's memory).  Checkpoints (``--ckpt-dir``, ``--ckpt-every``, ``--resume``) are in
the JAX package's format: either package resumes the other's.  The last
stdout line is the JSON summary of the JAX package's CLI plus ``device``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any

import torch

from repro_torch.comm import CommConfig
from repro_torch.configs import registry
from repro_torch.core import OuterConfig, TrainerConfig
from repro_torch.data import LoaderConfig
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import GossipProgram, LoopConfig, make_loop


def method_config(
    method: str,
    *,
    inner_lr: float,
    total_steps: int,
    warmup: int = 100,
    inner_steps: int | None = None,
    seed: int = 0,
    comm: CommConfig | None = None,
    stale: str = "naive",
) -> TrainerConfig:
    """Paper §4 hyper-parameters: β=0.7 both; NoLoCo α=0.5, m=50; DiLoCo
    α=0.3, m=100; inner AdamW + clip 1.0 + warmup-cosine."""
    sched = warmup_cosine(inner_lr, total_steps, warmup_steps=warmup)
    inner = AdamWConfig(lr=sched, weight_decay=0.1, clip_norm=1.0)
    if method == "noloco":
        outer = OuterConfig(method="noloco", alpha=0.5, beta=0.7,
                            inner_steps=inner_steps or 50, seed=seed, stale=stale)
    elif method == "diloco":
        outer = OuterConfig(method="diloco", alpha=0.3, beta=0.7,
                            inner_steps=inner_steps or 100, seed=seed)
    elif method in ("fsdp", "none"):
        outer = OuterConfig(method="none", inner_steps=10**9)
    else:
        raise ValueError(f"unknown method {method!r}")
    return TrainerConfig(outer=outer, inner=inner, comm=comm or CommConfig(),
                         sync_grads=method == "fsdp")


def run_training(
    cfg: ModelConfig,
    *,
    method: str = "noloco",
    replicas: int = 4,
    per_replica_batch: int = 4,
    seq_len: int = 128,
    steps: int = 100,
    total_steps: int | None = None,
    inner_lr: float = 3e-3,
    inner_steps: int | None = None,
    warmup: int | None = None,
    eval_every: int = 0,
    eval_batches: int = 2,
    seed: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    resume: bool = False,
    log: bool = False,
    log_jsonl: str | None = None,
    codec: str = "none",
    fuse: bool = True,
    streams: int = 1,
    overlap: bool = False,
    device: str = "cuda",
) -> dict[str, Any]:
    """Train; returns the loss and weight-std trajectories, the final state
    and the run summary (the JAX package's ``run_training`` contract), plus
    ``partners``, the partner table of every NoLoCo outer step.

    ``total_steps`` fixes the LR-schedule horizon independently of
    ``steps`` (default: equal); runs that will be interrupted and resumed
    must pin it.  ``resume`` restores the latest checkpoint under
    ``ckpt_dir`` (θ/φ/δ/AdamW/step counters; the loader is fast-forwarded),
    ``ckpt_every`` saves every N steps (0: only at the end).  ``device`` is
    ``cuda`` unless the caller asks for the CPU; without a GPU the default
    raises."""
    dev = resolve_device(device)
    horizon = total_steps or steps
    tcfg = method_config(
        method, inner_lr=inner_lr, total_steps=horizon,
        warmup=warmup if warmup is not None else max(horizon // 10, 1),
        inner_steps=inner_steps, seed=seed,
        comm=CommConfig(codec=codec, fuse=fuse, streams=streams, overlap=overlap),
    )
    program = GossipProgram(cfg, tcfg, replicas=replicas, seed=seed, device=dev)
    loop = make_loop(
        program,
        LoaderConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                     per_replica_batch=per_replica_batch, replicas=replicas, seed=seed),
        LoopConfig(steps=steps, eval_every=eval_every, seed=seed, ckpt_dir=ckpt_dir,
                   ckpt_every=ckpt_every, resume=resume, log_jsonl=log_jsonl, log=log,
                   run_name=f"{cfg.name}-{method}"),
        n_eval=eval_batches,
    )
    res = loop.run()
    res["partners"] = list(program.partners)
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-small-125m")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the arch")
    ap.add_argument("--method", default="noloco", choices=["noloco", "diloco", "fsdp", "none"])
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--inner-steps", type=int, default=None)
    ap.add_argument("--codec", default="none", choices=["none", "fp16", "bf16", "int8"],
                    help="gossip wire codec")
    ap.add_argument("--no-fuse", action="store_true",
                    help="per-leaf exchange instead of one fused buffer per dtype")
    ap.add_argument("--stream-count", type=int, default=1,
                    help="streaming outer steps: partition the payload into N "
                         "streams synced on staggered round offsets")
    ap.add_argument("--overlap", action="store_true",
                    help="§3.2 φ-prefetch overlap (auto-enabled by "
                         "--stream-count > 1)")
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
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
    res = run_training(
        cfg, method=args.method, replicas=args.replicas, per_replica_batch=args.batch,
        seq_len=args.seq, steps=args.steps, inner_lr=args.lr, inner_steps=args.inner_steps,
        eval_every=args.eval_every, seed=args.seed, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume, log=True, log_jsonl=args.log_jsonl,
        codec=args.codec, fuse=not args.no_fuse, streams=args.stream_count,
        overlap=args.overlap or args.stream_count > 1, device=args.device,
    )
    summary = {
        "arch": cfg.name, "method": args.method, "codec": args.codec,
        "stream_count": res.get("stream_count", 1),
        "blocking_fraction": round(res["blocking_fraction"], 4),
        "final_train_loss": res["losses"][-1] if res["losses"] else None,
        "final_eval": res["evals"][-1][1] if res["evals"] else None,
        "final_weight_std": res["final_weight_std"],
        "tokens_per_s": round(res["tokens_per_s"], 1),
        "wall_s": round(res["wall_s"], 1),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(summary))
    if args.out:
        res.pop("state")
        res["partners"] = [p.tolist() for p in res["partners"]]
        with open(args.out, "w") as f:
            json.dump(res, f)
    return summary


if __name__ == "__main__":
    main()
