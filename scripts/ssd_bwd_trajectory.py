"""How far mamba2-370m's bf16 training trajectory moves with the SSD
backward's rounding, on the card.

    python3 scripts/ssd_bwd_trajectory.py

Trains mamba2-370m at full width and depth with ``chip_smoke.py``'s
training run (NoLoCo, 4 replicas × batch 4 × 1,024 tokens, 10 steps,
inner lr 3e-3, seed 0) three times from the same initial state, with the
SSD chunk scan's backward taken by: the CUDA kernel
(``ssd_scan.ssd_chunk_bwd``); its plain PyTorch version in fp32
(``ref.torch_ssd_chunk_intra_bwd``, an independent summation order); and
the plain version evaluated in fp64 and rounded once to fp32 (the nearest
to exact).  Prints one JSON line per run with its losses, then each pair's
largest relative loss difference at step 2 and over the run.  Every line
is JSON; the first names the card and its power limit.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import mamba2_370m  # noqa: E402
from repro_torch.kernels import ref, ssd_scan  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

RUN = dict(method="noloco", replicas=4, per_replica_batch=4, seq_len=1024, steps=10,
           inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0)


def f64_bwd(x, dt, a, b_mat, c_mat, dy, dst):
    """The plain backward's vjp in fp64 on the fp32 inputs, rounded to fp32."""
    ins = [t.double().requires_grad_() for t in (x, dt, a, b_mat, c_mat)]
    with torch.enable_grad():
        q = x.shape[2]
        rates = ins[2][None, None, None] if a.dim() == 1 else ins[2][:, None, None]
        cums = torch.cumsum(ins[1] * rates, dim=2)
        diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
        l_kern = torch.exp(torch.where(tri, diff, torch.full_like(diff, -math.inf)))
        xdt = ins[0] * ins[1][..., None]
        s = torch.einsum("bcin,bcjn->bcij", ins[4], ins[3])
        y = torch.einsum("bcij,bcijh,bcjhp->bcihp", s, l_kern, xdt)
        st = torch.einsum("bcjn,bcjh,bcjhp->bchnp", ins[3], torch.exp(cums[:, :, -1:] - cums), xdt)
        grads = torch.autograd.grad((y, st), ins, (dy.double(), dst.double()))
    return tuple(g.float() for g in grads)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_trajectory: needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = ssd_scan.ssd_chunk_bwd
    losses = {}
    for name, bwd in (("kernel", kernel), ("plain_fp32", ref.torch_ssd_chunk_intra_bwd),
                      ("plain_fp64", f64_bwd)):
        ssd_scan.ssd_chunk_bwd = bwd
        try:
            out = train_cli.run_training(mamba2_370m.CONFIG, device="cuda", **RUN)
        finally:
            ssd_scan.ssd_chunk_bwd = kernel
        losses[name] = out["losses"]
        print(json.dumps({"backward": name, "losses": out["losses"]}), flush=True)
        torch.cuda.empty_cache()
    names = list(losses)
    for i, p in enumerate(names):
        for q in names[i + 1:]:
            rel = [abs(x - y) / abs(y) for x, y in zip(losses[p], losses[q])]
            print(json.dumps({"pair": [p, q], "step2_rel_diff": rel[1], "max_rel_diff": max(rel)}),
                  flush=True)


if __name__ == "__main__":
    main()
