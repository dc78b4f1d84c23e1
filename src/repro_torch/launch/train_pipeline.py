"""Routed-pipeline training CLI of the port — the paper's complete method
(§3.1 + §3.2): random microbatch routing between stage replicas and the
per-stage gossip outer step, driven by the training engine.

    PYTHONPATH=src python -m repro_torch.launch.train_pipeline \
        --arch paper-small-125m --stages 2 --replicas 4 --method noloco \
        --batch 4 --seq 1024 --steps 100 --inner-steps 5

    # reduced config on the CPU (plain PyTorch attention and outer update):
    PYTHONPATH=src python -m repro_torch.launch.train_pipeline --device cpu \
        --reduced --stages 2 --replicas 4 --steps 10 --inner-steps 5 --seq 32

``--method none`` is the §5.2 routing-only baseline (no outer step);
``--routing fixed`` is classic pipelining.  ``--reduced`` trains the smoke
variant of the arch (vocabulary min(V, 512), no remat, fp32).  On the card
the attention forward and backward, the NoLoCo outer update and the int8
codec run the hand-written CUDA kernels; ``--device`` defaults to ``cuda``
and raises without a GPU.  Checkpoints (``--ckpt-dir``, ``--ckpt-every``,
``--resume``) are in the JAX package's format: either package resumes the
other's.  The last stdout line is the JAX package's summary JSON plus
``device``.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.comm import CommConfig
from repro_torch.configs import registry
from repro_torch.core.outer import OuterConfig
from repro_torch.data import LoaderConfig
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.pipeline import PipelineTrainer
from repro_torch.train import LoopConfig, PipelineProgram, make_loop


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-small-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--method", default="noloco", choices=["noloco", "diloco", "none"])
    ap.add_argument("--routing", default="random", choices=["random", "fixed"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--inner-steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--codec", default="none", choices=["none", "fp16", "bf16", "int8"])
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
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
    if cfg.num_layers % args.stages:
        raise SystemExit(f"num_layers={cfg.num_layers} must divide into --stages={args.stages}")

    outer = None
    if args.method != "none":
        outer = OuterConfig(method=args.method, inner_steps=args.inner_steps, seed=args.seed)
    trainer = PipelineTrainer(
        cfg, num_stages=args.stages, replicas=args.replicas,
        inner=AdamWConfig(lr=args.lr, weight_decay=0.0), routing=args.routing, outer=outer,
        comm=CommConfig(codec=args.codec), device=device, seed=args.seed,
    )
    loop = make_loop(
        PipelineProgram(trainer),
        LoaderConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, per_replica_batch=args.batch,
                     replicas=args.replicas, seed=args.seed),
        LoopConfig(steps=args.steps, eval_every=args.eval_every, seed=args.seed,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, resume=args.resume,
                   log_jsonl=args.log_jsonl, log=True,
                   run_name=f"{cfg.name}-pipe-{args.method}"),
    )
    res = loop.run()
    summary = {
        "arch": cfg.name, "stages": args.stages, "replicas": args.replicas,
        "method": args.method, "routing": args.routing,
        "final_loss": res["losses"][-1] if res["losses"] else None,
        "final_weight_std": res["final_weight_std"],
        "outer_syncs": res["outer_syncs"],
        "comm_bytes": res["comm_bytes"],
        "tokens_per_s": round(res["tokens_per_s"], 1),
        "wall_s": round(res["wall_s"], 1),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
