#!/usr/bin/env python3
"""Train, checkpoint, resume and serve paper-small-125m at its published
width through the PyTorch port's CLIs, on one GPU:

    python3 scripts/port_ckpt_flow.py [DIR]      (default build/ckpt_flow)

1. ``repro_torch.launch.train`` — NoLoCo over the int8 wire, 4 replicas ×
   batch 4 × seq 1024, 5 inner steps, 10 steps, a checkpoint every 5;
2. the same command resumed to 20 steps;
3. ``repro_torch.launch.serve --full --ckpt DIR --replica 1 --weights phi``.

Prints each command's wall time, the checkpoint events (save seconds per
checkpoint) and sizes, the first run's losses beside the resumed run's, and
the serve summary; exits non-zero when a command fails.  The checkpoints
(~10.3 GB each, three kept) are deleted at the end.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["--arch", "paper-small-125m", "--method", "noloco", "--codec", "int8",
         "--replicas", "4", "--batch", "4", "--seq", "1024", "--inner-steps", "5"]


def run(args: list[str]) -> tuple[float, str]:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"failed ({proc.returncode}): {' '.join(args)}")
    last = proc.stdout.strip().splitlines()[-1]
    print(f"wall_s {wall:.3f}: {' '.join(args)}\n  {last}", flush=True)
    return wall, last


def main() -> None:
    d = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "build", "ckpt_flow"))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    print(f"free disk under {d}: {shutil.disk_usage(d).free / 1e9:.1f} GB", flush=True)
    log = os.path.join(d, "train.jsonl")
    try:
        run(["repro_torch.launch.train", *TRAIN, "--steps", "10", "--ckpt-dir", d,
             "--ckpt-every", "5", "--log-jsonl", log])
        run(["repro_torch.launch.train", *TRAIN, "--steps", "20", "--ckpt-dir", d, "--resume",
             "--log-jsonl", log])
        events = [json.loads(line) for line in open(log)]
        for e in events:
            if e["event"] in ("ckpt", "run_start"):
                print("  " + json.dumps({k: e[k] for k in e if k != "comm"}))
        for name in sorted(os.listdir(d)):
            if name.startswith("step_"):
                size = sum(os.path.getsize(os.path.join(d, name, f))
                           for f in os.listdir(os.path.join(d, name)))
                print(f"  {name}: {size:,} B")
        losses = [e["loss"] for e in events if e["event"] == "step"]
        print("  losses (steps 1-10, then resumed 11-20): " + json.dumps(losses))
        run(["repro_torch.launch.serve", "--full", "--arch", "paper-small-125m", "--ckpt", d,
             "--replica", "1", "--weights", "phi", "--log-jsonl", os.path.join(d, "serve.jsonl")])
    finally:
        for name in os.listdir(d):
            if name.startswith("step_"):
                shutil.rmtree(os.path.join(d, name), ignore_errors=True)


if __name__ == "__main__":
    main()
