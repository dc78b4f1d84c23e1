"""Time phase 6 of ``chip_smoke.py`` with two per-replica gradient norms, in turns.

    python3 scripts/time_grad_norm.py

paper-small-125m at full width, 4 replicas × 4 × 1024, m 5, 10 steps,
through ``chip_smoke.train_phase``, with AdamW's clipping norm taken two
ways: ``batched``, one reduction over all replica rows of a leaf (which
the stacked trainer used until a rank of the replica group had to equal a
stacked row bit for bit), and ``per_row``, the port's
``optim.adamw.global_norm``, which reduces each row alone.  The order is
batched, per_row, per_row, batched, so two versions read on one card.
The script's own lines are JSON objects (the phase's log lines come
between them); the first names the card and its power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import torch

    import chip_smoke
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    def batched_global_norm(tree):
        def square_sum(x):
            flat = x.flatten(1)
            if flat.numel() <= 1 << 30:
                return flat.float().square().sum(1)
            return torch.stack([flat[:, i:i + adamw.SLICE].float().square().sum(1)
                                for i in range(0, flat.shape[1], adamw.SLICE)]).sum(0)

        return torch.stack([square_sum(x) for x in tree_leaves(tree)]).sum(0).sqrt()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0]}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.build.build_all()
    dev = torch.device("cuda", 0)
    norms = {"batched": batched_global_norm, "per_row": adamw.global_norm}
    try:
        for name in ("batched", "per_row", "per_row", "batched"):
            adamw.global_norm = norms[name]
            s, _ = chip_smoke.train_phase(dev, label=f"train {name}")
            print(json.dumps({"norm": name, **{k: s[k] for k in (
                "inner_step_p50_ms", "inner_step_p99_ms", "peak_memory_gb")}}), flush=True)
    finally:
        adamw.global_norm = norms["per_row"]


if __name__ == "__main__":
    main()
