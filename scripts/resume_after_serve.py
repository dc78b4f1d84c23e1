"""Phase 11's resume after the serving phases, in one process, on the card.

    python3 scripts/resume_after_serve.py [--rounds 3]

Each round serves qwen3-0.6b through ``chip_smoke.serve_phase`` and then
runs phase 11's training three ways in the same process (``reduced()``
paper-small-125m in fp32 on the int8 wire, ``chip_smoke.CKPT_RUN``): 12
straight steps twice, and 6 steps saved and resumed to 12.  It prints the
first step whose loss differs and the leaves of θ, φ, δ and both AdamW
moments that differ, for the resumed run and for the second straight run,
and stops at the first round with a difference.  Then it fills the CUDA
caching allocator's free blocks with 0, NaN and 1e30 in turn (one large
block and 3,000 small ones) before the straight run: a kernel that reads
memory it did not write gives other bits.  The first line names the card
and its power limit; the script's records are the ``ckpt diag`` and
``poison diag`` lines.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ckpt_diag(C, tag) -> dict:
    import torch

    from repro_torch.launch import train as train_cli
    from repro_torch.tree import tree_leaves

    cfg = C.paper_llama.SMALL.reduced(dtype="float32", remat=False)
    d = os.path.join(os.path.dirname(os.path.abspath(C.__file__)), "build", f"ckpt_diag_{tag}")
    shutil.rmtree(d, ignore_errors=True)
    full = train_cli.run_training(cfg, device="cuda", steps=12, **C.CKPT_RUN)
    full2 = train_cli.run_training(cfg, device="cuda", steps=12, **C.CKPT_RUN)
    train_cli.run_training(cfg, device="cuda", steps=6, ckpt_dir=d, ckpt_every=3, **C.CKPT_RUN)
    cont = train_cli.run_training(cfg, device="cuda", steps=12, ckpt_dir=d, resume=True,
                                  **C.CKPT_RUN)
    torch.cuda.synchronize()
    shutil.rmtree(d, ignore_errors=True)
    first = lambda a, b: next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    out = {"tag": tag, "resume_loss_first_diff": first(cont["losses"], full["losses"][6:]),
           "rerun_loss_first_diff": first(full2["losses"], full["losses"])}
    for name, pick in (("theta", lambda s: s.theta), ("phi", lambda s: s.outer.phi),
                       ("delta", lambda s: s.outer.delta), ("mu", lambda s: s.opt.mu),
                       ("nu", lambda s: s.opt.nu)):
        for other, st in (("cont", cont["state"]), ("full2", full2["state"])):
            bad = [(i, float((x.float() - y.float()).abs().max())) for i, (x, y) in
                   enumerate(zip(tree_leaves(pick(st)), tree_leaves(pick(full["state"]))))
                   if not torch.equal(x, y)]
            out[f"{name}_{other}_differing_leaves"] = bad[:5]
            out[f"{name}_{other}_n_differing"] = len(bad)
    C.log("ckpt diag: " + json.dumps(out))
    return out


def poison(dev, value) -> None:
    """Fill the allocator's free memory with ``value``, then free it (the
    blocks stay in PyTorch's cache for the next allocations)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    blocks = [torch.empty(int(free * 0.6) // 4, dtype=torch.float32, device=dev)]
    blocks += [torch.empty((1 << 17) + i, dtype=torch.float32, device=dev) for i in range(3000)]
    for t in blocks:
        t.fill_(value)
    torch.cuda.synchronize()


def poison_diag(C, dev) -> dict:
    import torch

    from repro_torch.launch import train as train_cli
    from repro_torch.tree import tree_leaves

    cfg = C.paper_llama.SMALL.reduced(dtype="float32", remat=False)
    runs = {}
    for value in (0.0, float("nan"), 1e30, 0.0):
        poison(dev, value)
        r = train_cli.run_training(cfg, device="cuda", steps=12, **C.CKPT_RUN)
        runs.setdefault(str(value), []).append(
            (r["losses"], [x.clone() for x in tree_leaves(r["state"].theta)]))
    base_l, base_t = runs["0.0"][0]
    out = {f"{k}#{j}": {"losses_equal": l == base_l,
                        "theta_equal": all(torch.equal(a, b) for a, b in zip(t, base_t)),
                        "nan": any(x != x for x in l)}
           for k, rs in runs.items() for j, (l, t) in enumerate(rs)}
    C.log("poison diag (reduced fp32 int8 training after the allocator cache was filled with "
          "a value): " + json.dumps(out))
    return out


def main() -> None:
    import torch

    import chip_smoke as C
    from repro_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("resume_after_serve: no GPU")
    C.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    for i in range(args.rounds):
        C.serve_phase(dev)
        diag = ckpt_diag(C, i)
        if diag["resume_loss_first_diff"] is not None or diag["theta_cont_n_differing"]:
            break
    poison_diag(C, dev)


if __name__ == "__main__":
    main()
