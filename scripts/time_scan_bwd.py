"""Time the two scan backwards of one or more checkouts on the card, in turns.

    python3 scripts/time_scan_bwd.py [--sass] [ROOT ...]   (default ROOT: this checkout)

``ssd_chunk_bwd`` runs at mamba2-370m's training shape (16, 8, 128, 32, 64,
N 128, a per row) and ``rglru_scan_bwd`` at recurrentgemma-9b's (2, 1024,
4096) and at (16, 1024, 4096).  Each ROOT is a checkout's root directory:
its ``src`` is imported in a process of its own (each builds its kernels
into its own ``build/``), and the roots are timed in the order given, so
``parent change change parent`` reads two versions on one card.  Times are
medians of CUDA-event times with L2 flushed before each call, as
``chip_smoke.py`` takes them.  ``--sass`` also prints, for each kernel of
the two libraries, the counts of its global loads and stores, ``cp.async``
copies, shared loads and tensor-core instructions in the SASS that
``cuobjdump`` reads from the built library.  Every line is JSON; the first
names the card and its power limit.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

CHILD = r'''
import json, math, re, statistics, sys, torch
from repro_torch.kernels import build, rglru_scan, ssd_scan

def ms(fn, reps):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record(); fn(); b.record(); b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)

gen = torch.Generator(device="cuda").manual_seed(0)
res = {"root": sys.argv[1]}
def ssd_inputs(b=16, nc=8, q=128, h=32, p=64, n=128):
    x = torch.randn((b, nc, q, h, p), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=gen, device="cuda") - 2.0)
    a = -torch.exp(torch.rand((b, h), generator=gen, device="cuda") * math.log(16.0))
    bm, cm = (torch.randn((b, nc, q, n), generator=gen, device="cuda") for _ in range(2))
    dy = torch.randn((b, nc, q, h, p), generator=gen, device="cuda")
    dst = torch.randn((b, nc, h, n, p), generator=gen, device="cuda")
    return x, dt, a, bm, cm, dy, dst

x, dt, a, bm, cm, dy, dst = ssd_inputs()
res["ssd_chunk_bwd"] = ms(lambda: ssd_scan.ssd_chunk_bwd(x, dt, a, bm, cm, dy, dst), 20)
del x, dt, a, bm, cm, dy, dst
for key, shape in (("rglru_scan_bwd", (2, 1024, 4096)), ("rglru_scan_bwd_16", (16, 1024, 4096))):
    aa = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda")) * 0.5 + 0.45
    hh, gg = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    res[key] = ms(lambda: rglru_scan.rglru_scan_bwd(aa, hh, gg), 50)
from torch.profiler import ProfilerActivity, profile
x, dt, a, bm, cm, dy, dst = (t.contiguous() for t in ssd_inputs())
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        ssd_scan.ssd_chunk_bwd(x, dt, a, bm, cm, dy, dst)
    torch.cuda.synchronize()
split = {}
for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CUDA and "ssd_bwd" in e.name:
        k = re.search(r"ssd_bwd_(\w+?)_kernel", e.name).group(1)
        split[k] = split.get(k, 0.0) + getattr(e, "device_time", getattr(e, "cuda_time", 0.0)) / 5e3
res["ssd_chunk_bwd_split_ms"] = split
res["libraries"] = {name: str(build.library_path(name)) for name in ("ssd_scan", "rglru_scan")}
print(json.dumps(res))
'''

SASS_OPS = ("LDG", "STG", "LDGSTS", "LDS", "STS", "HMMA", "BAR")


def sass_counts(lib: str) -> dict[str, dict[str, int]]:
    """Per kernel, the count of each SASS op in SASS_OPS."""
    dump = subprocess.run([os.environ.get("CUOBJDUMP", "/usr/local/cuda/bin/cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if name and m and m.group(1) in SASS_OPS:
            out[name][m.group(1)] += 1
    return out


def main() -> None:
    args = sys.argv[1:]
    sass = "--sass" in args
    roots = [Path(r).resolve() for r in args if r != "--sass"] or [HERE]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    seen = set()
    for root in roots:
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        run = subprocess.run([sys.executable, "-c", CHILD, str(root)], env=env, capture_output=True,
                             text=True)
        if run.returncode != 0:
            raise SystemExit(f"{root}: exit {run.returncode}\n{run.stderr[-4000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        libs = res.pop("libraries")
        print(json.dumps(res), flush=True)
        if sass and root not in seen:
            seen.add(root)
            for name, lib in libs.items():
                counts = {k: v for k, v in sass_counts(lib).items() if "bwd" in k}
                print(json.dumps({"root": str(root), "sass": name, "kernels": counts}), flush=True)


if __name__ == "__main__":
    main()
