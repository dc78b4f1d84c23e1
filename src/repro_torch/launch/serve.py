"""Serving CLI of the port: continuous batching over the paged KV cache,
with paged attention and the recurrent scans and decode steps in
hand-written CUDA kernels on the card.

Generates a synthetic mixed-length request load and serves it through
:class:`repro_torch.serve.ServeEngine` on weights initialised from
``--seed``, or on one replica promoted from a training checkpoint of either
package (``--ckpt``, ``--step``, ``--replica``, ``--weights theta|phi``).
Runs on CUDA unless ``--device cpu`` is given; with no GPU it raises.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --requests 8 --max-batch 4 --prompt-lens 24,80,200 --gen-lens 16,32

    # replica 1's outer weights φ from the latest checkpoint under D:
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch paper-small-125m --ckpt D --replica 1 --weights phi

    # the recurrent families: Mamba-2 SSD, RG-LRU with local attention
    PYTHONPATH=src python -m repro_torch.launch.serve --full --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.serve --full --arch recurrentgemma-9b

    # small config on the CPU (the plain versions of the kernels):
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu [--arch mamba2-370m]

    # single-shot prefill (the flash op over each whole prompt):
    PYTHONPATH=src python -m repro_torch.launch.serve --full --prefill-chunk 0

    # ensemble speculative decode: replica 2 drafts for replica 1, and
    # --verify re-decodes on a plain engine (target-only tokens):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-small-125m \
        --ckpt D --replica 1 --spec-decode --draft-replica 2 --verify
    # or a draft of the target's first N layers (default: half of them):
    PYTHONPATH=src python -m repro_torch.launch.serve --full --spec-decode --draft-layers 14

Without ``--full`` (or with the JAX CLI's ``--reduced``, the default) the
architecture is cut by ``ModelConfig.reduced()`` to a two-layer fp32 smoke
model; with ``--full`` the published config is served in its own dtype; a
promoted checkpoint must have that config's shapes.  The last
stdout line is the run_end summary JSON, with the same keys as the JAX
package's ``repro.launch.serve`` (``promoted``: the resolved step, replica,
source and world of a promoted checkpoint; with ``--spec-decode`` also
``spec_k``, ``spec_rounds``, ``accept_rate`` and ``draft``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import (
    Request,
    ServeConfig,
    ServeEngine,
    SpecServeEngine,
    promote,
    truncate_layers,
)


def synth_requests(
    n: int, vocab: int, prompt_lens: list[int], gen_lens: list[int],
    temps: list[float], seed: int,
) -> list[Request]:
    """Synthetic load: prompts and generation budgets cycled from the given
    buckets, prompt tokens drawn from ``seed`` (the JAX CLI's load)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        pl = prompt_lens[i % len(prompt_lens)]
        gl = gen_lens[i % len(gen_lens)]
        prompt = rng.integers(0, vocab, size=(pl,)).tolist()
        reqs.append(
            Request(rid=i, prompt=[int(t) for t in prompt], max_new=gl,
                    temperature=temps[i % len(temps)])
        )
    return reqs


def serve_run(
    params, cfg, scfg: ServeConfig, requests: list[Request],
    *, verify: bool = False, log=None, draft=None, spec_k: int = 4,
    stream_every: int = 0,
) -> dict:
    """Run one serving load; returns the run_end summary dict.
    ``draft=(draft_params, draft_cfg)`` switches on speculative decode.
    ``verify`` re-decodes every request solo on a plain engine and counts
    token mismatches, so with a draft it holds speculative output against
    target-only output."""
    if draft is not None:
        engine = SpecServeEngine(params, cfg, scfg, draft[0], draft[1], spec_k=spec_k)
    else:
        engine = ServeEngine(params, cfg, scfg)
    token_cb = None
    if log and stream_every:
        def token_cb(rid, index, token, t):
            log({"event": "token", "rid": rid, "index": index,
                 "token": token, "t": round(t, 6)})
    t0 = time.perf_counter()
    finished = engine.run(
        [dataclasses.replace(r) for r in requests],
        token_cb=token_cb, drain_every=stream_every,
    )
    wall = time.perf_counter() - t0
    gen_tokens = sum(len(f.tokens) for f in finished)
    ttfts = sorted(f.ttft_s for f in finished)
    summary = {
        "event": "run_end",
        "policy": scfg.policy,
        "prefill_chunk": scfg.prefill_chunk,
        "requests": len(finished),
        "gen_tokens": gen_tokens,
        "wall_s": round(wall, 4),
        "tokens_per_s": round(gen_tokens / max(wall, 1e-9), 2),
        "decode_steps": engine.decode_steps,
        "ttft_p50_s": round(float(np.percentile(ttfts, 50)), 4),
        "ttft_p99_s": round(float(np.percentile(ttfts, 99)), 4),
    }
    if draft is not None:
        summary["spec_k"] = spec_k
        summary["spec_rounds"] = engine.spec_rounds
        summary["accept_rate"] = round(engine.accept_rate, 4)
    if engine.decode_step_times:
        st = np.asarray(engine.decode_step_times)
        summary["step_p50_s"] = round(float(np.percentile(st, 50)), 5)
        summary["step_p99_s"] = round(float(np.percentile(st, 99)), 5)
    if log:
        for f in sorted(finished, key=lambda f: f.rid):
            log({"event": "finish", "rid": f.rid, "prompt_len": len(f.prompt),
                 "gen_len": len(f.tokens), "ttft_s": round(f.ttft_s, 4),
                 "tokens": f.tokens, **f.stats})
    if verify:
        batched = {f.rid: f.tokens for f in finished}
        mismatches = 0
        for r in requests:
            [f] = ServeEngine(params, cfg, scfg).run([dataclasses.replace(r)])
            mismatches += f.tokens != batched[r.rid]
        summary["verify_requests"] = len(requests)
        summary["verify_mismatches"] = mismatches
        summary["parity"] = mismatches == 0
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", action="store_true",
                      help="serve the published config (default: its reduced() smoke variant)")
    size.add_argument("--reduced", dest="full", action="store_false",
                      help="serve the reduced() smoke variant (the default; the JAX CLI's flag)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs the plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--pages", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prompt-lens", default="4,12,24",
                    help="comma-separated prompt-length buckets, cycled")
    ap.add_argument("--gen-lens", default="8,16,32",
                    help="comma-separated generation budgets, cycled")
    ap.add_argument("--temps", default="0.0",
                    help="comma-separated sampling temperatures, cycled (0=greedy)")
    ap.add_argument("--policy", default="continuous", choices=["continuous", "static"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="promote a training checkpoint from this directory")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--replica", type=int, default=0,
                    help="which NoLoCo replica to promote")
    ap.add_argument("--weights", default="theta", choices=["theta", "phi"],
                    help="promote the inner weights (theta) or outer anchor (phi)")
    ap.add_argument("--verify", action="store_true",
                    help="re-decode each request solo and assert exact match")
    ap.add_argument("--sync-each-step", action="store_true",
                    help="block per decode step for per-token latency stats")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="chunked-prefill width; 0 = single-shot prefill")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prefill tokens per tick (0 = unlimited)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="ensemble speculative decode (draft replica or truncated slice)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative round width (draft steps per round)")
    ap.add_argument("--draft-replica", type=int, default=None,
                    help="promote this replica as the draft (needs --ckpt)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="draft with the target's first N layers "
                         "(default: half, when no --draft-replica)")
    ap.add_argument("--stream-every", type=int, default=0,
                    help="drain streamed `token` JSONL events every N ticks "
                         "(0 = tokens only surface at request finish)")
    ap.add_argument("--log-jsonl", default=None,
                    help="append one JSON telemetry event per line to this file")
    return ap


def resolve_config(args: argparse.Namespace):
    """The config ``--arch`` names: published with ``--full``, else its
    two-layer fp32 ``reduced()`` variant, as the JAX CLI's ``--reduced``."""
    cfg = registry.get_config(args.arch)
    return cfg if args.full else cfg.reduced(dtype="float32", remat=False)


def main(argv: list[str] | None = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.spec_decode and args.draft_replica is not None and not args.ckpt:
        ap.error("--draft-replica needs --ckpt")
    device = resolve_device(args.device)
    cfg = resolve_config(args)
    promo_info = None
    if args.ckpt:
        params, promo_info = promote(args.ckpt, cfg, step=args.step, replica=args.replica,
                                     source=args.weights, device=device)
    else:
        params = M.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg)

    jsonl = open(args.log_jsonl, "a") if args.log_jsonl else None
    try:
        def log(ev: dict) -> None:
            if jsonl:
                jsonl.write(json.dumps(ev) + "\n")
                jsonl.flush()

        prompt_lens = [int(x) for x in args.prompt_lens.split(",")]
        gen_lens = [int(x) for x in args.gen_lens.split(",")]
        temps = [float(x) for x in args.temps.split(",")]
        scfg = ServeConfig(
            max_slots=args.max_batch, num_pages=args.pages, page_size=args.page_size,
            max_new_cap=max(gen_lens), policy=args.policy,
            sync_each_step=args.sync_each_step,
            prefill_chunk=args.prefill_chunk, prefill_budget=args.prefill_budget,
        )
        draft = draft_info = None
        if args.spec_decode:
            if args.draft_replica is not None:
                dparams, dinfo = promote(args.ckpt, cfg, step=args.step,
                                         replica=args.draft_replica, source=args.weights,
                                         device=device)
                draft, draft_info = (dparams, cfg), {"kind": "replica", **dinfo}
            else:
                n = args.draft_layers or max(1, cfg.num_layers // 2)
                draft = truncate_layers(params, cfg, n)
                draft_info = {"kind": "truncated", "layers": n}
        requests = synth_requests(
            args.requests, cfg.vocab_size, prompt_lens, gen_lens, temps, args.seed
        )
        log({"event": "run_start", "arch": cfg.name, "policy": args.policy,
             "requests": args.requests, "max_batch": args.max_batch,
             "pages": args.pages, "page_size": args.page_size,
             "prefill_chunk": args.prefill_chunk, "spec_decode": bool(args.spec_decode),
             "draft": draft_info, "device": str(device), "promoted": promo_info})
        summary = serve_run(
            params, cfg, scfg, requests, verify=args.verify, log=log,
            draft=draft, spec_k=args.spec_k, stream_every=args.stream_every,
        )
        if draft_info:
            summary["draft"] = draft_info
        summary["arch"] = cfg.name
        if promo_info:
            summary["promoted"] = promo_info
        summary["device"] = (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        )
        log(summary)
    finally:
        if jsonl:
            jsonl.close()
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
