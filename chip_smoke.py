#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. print the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build the CUDA kernels from ``src/repro_torch/csrc`` and print the build
   seconds and ``ptxas``'s register and shared-memory report;
3. hold each kernel against its plain PyTorch version on the card at
   qwen3-0.6b shapes (H 16, KV 8, D 128, BS 16, R 4, C 32; causal and local
   with window 64, bf16 and fp32, plus ragged heads H 6 / KV 4), then time
   kernel, plain version and ``scaled_dot_product_attention`` on the
   gathered dense K/V (the library yardstick, which the port never calls);
4. serve qwen3-0.6b at its published width in bf16 on weights from seed 0:
   8 requests, 4 slots, prompts 24/80/200, generation 16/32, 128 pages of
   16, chunked prefill 32, greedy.  Launch counts are zeroed just before the
   run and read just after; both kernels must have launched.  Two requests
   are decoded again alone and must give the same tokens, and one short
   request is served under ``torch.profiler`` to split its wall time into
   device busy time and the rest;
5. run one 40-token prompt plus 8 greedy decode steps of the full-width
   model in fp32 on the card (kernels) and on the CPU (plain versions), on
   the same weights: identical tokens, logits within fp32 tolerance.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import qwen3_0_6b  # noqa: E402
from repro_torch.kernels import build, dispatch, paged_attention  # noqa: E402
from repro_torch.launch.serve import serve_run, synth_requests  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.attention import PagedView  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and per-type compute.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances of the kernel checks.  fp32: the kernel and the plain version
# sum in different orders.  bf16: both round an fp32 result to bf16, so they
# may differ by one bf16 ulp of the output (2**-6 for |out| in [2, 4)).
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Whole-model fp32 logits, card vs CPU: 28 layers of sums in another order.
LOGIT_ATOL = 2e-3

H, KV, D, BS, R, C, WINDOW = 16, 8, 128, 16, 4, 32, 64
NUM_PAGES = 128
SPIN_CYCLES = 4_000_000              # ~2 ms at the H100's boost clock
DECODE_POS = [231, 111, 47, 215]     # context lengths of the serve phase's mix
CHUNK_BASE = [0, 32, 64, 168]        # chunk starts of 24/80/200-token prompts


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(gen, *, chunk, dtype, h=H, kv=KV, r=R, positions=None):
    """Pools of NUM_PAGES pages plus trash, each slot owning its own pages in
    a random order; table entries past a slot's pages are stale ids of other
    slots or trash, as an engine that has evicted requests leaves them."""
    dev = gen.device
    pos = positions if positions is not None else (CHUNK_BASE if chunk else DECODE_POS)[:r]
    last = [p + (C - 1 if chunk else 0) for p in pos]
    perm = torch.randperm(NUM_PAGES, generator=gen, device=dev).to(torch.int32)
    tables = torch.full((r, NUM_PAGES), NUM_PAGES, dtype=torch.int32, device=dev)
    start = 0
    for i, t in enumerate(last):
        n = t // BS + 1
        tables[i, :n] = perm[start:start + n]
        stale = (torch.arange(4, device=dev) + start + n) % NUM_PAGES
        tables[i, n:n + 4] = perm[stale]
        start += n
    qshape = (r, C, h, D) if chunk else (r, h, D)
    q = torch.randn(qshape, generator=gen, device=dev).to(dtype)
    kp = torch.randn((NUM_PAGES + 1, BS, kv, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((NUM_PAGES + 1, BS, kv, D), generator=gen, device=dev).to(dtype)
    return q, kp, vp, tables, torch.tensor(pos, dtype=torch.int32, device=dev)


def check_kernels(dev) -> dict[str, float]:
    gen = torch.Generator(device=dev).manual_seed(1)
    errors = {}
    for name, op in dispatch.registry().items():
        chunk = name == "paged_chunk_attention"
        worst = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            for mode, window, h, kv in (("causal", 0, H, KV), ("local", WINDOW, H, KV),
                                        ("causal", 0, 6, 4)):
                args = kernel_inputs(gen, chunk=chunk, dtype=dtype, h=h, kv=kv)
                got = op.kernel(*args, mode=mode, window=window)
                torch.cuda.synchronize()
                want = op.plain(*args, mode=mode, window=window)
                if got.dtype != dtype or got.shape != args[0].shape:
                    raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
                err = (got.float() - want.float()).abs().max().item()
                ok = math.isfinite(err) and err <= ATOL[dtype]
                log(f"check {name} {str(dtype)[6:]} {mode} H{h}/KV{kv}: "
                    f"max_abs_err {err:.3e} (atol {ATOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain version")
                worst = max(worst, err)
        errors[name] = worst
    return errors


def cuda_ms(fn, reps: int = 100) -> tuple[float, float]:
    """Median device time of ``fn`` over ``reps`` calls, and the SM clock the
    card ran at meanwhile.  L2 is flushed before each call (every layer has
    its own pools, so the engine finds them cold).  A spin of SPIN_CYCLES on
    the stream holds the device while the host enqueues the start event,
    ``fn``'s launches and the end event, so the host's own time to launch is
    not counted; the spin's own duration gives the clock in MHz."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    times, spins = [], []
    for _ in range(reps):
        flush.zero_()
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        spins.append(s0.elapsed_time(a))
    return statistics.median(times), SPIN_CYCLES / statistics.median(spins) / 1e3


def sdpa_inputs(q, kp, vp, tables, positions, chunk):
    """Dense per-slot K/V gathered through the tables, heads expanded, with
    the positional mask: what one library attention call needs."""
    r = tables.shape[0]
    c = q.shape[1] if chunk else 1
    t = int(positions.max()) + c
    blocks = -(-t // BS)
    idx = tables[:, :blocks].long()
    k = kp[idx].reshape(r, blocks * BS, KV, D)[:, :t]
    v = vp[idx].reshape(r, blocks * BS, KV, D)[:, :t]
    g = H // KV
    k = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()   # (R, H, T, D)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    qd = (q if chunk else q[:, None]).transpose(1, 2).contiguous()  # (R, H, C, D)
    q_pos = positions[:, None].long() + torch.arange(c, device=q.device)[None]
    mask = torch.arange(t, device=q.device)[None, None] <= q_pos[:, :, None]  # (R, C, T)
    return qd, k, v, mask[:, None]


def bound(q, kp, positions, chunk, kv=KV, d=D):
    """Least time for the work: every live K/V entry, q and out moved once
    (plus the live table entries and positions), against 4·D flops per (query
    row, visible key)."""
    esz = q.element_size()
    c = q.shape[1] if chunk else 1
    h = q.shape[-2]
    live_keys = sum(p + c for p in positions.tolist())
    live_pages = sum(-(-(p + c) // BS) for p in positions.tolist())
    nbytes = 2 * live_keys * kv * d * esz + 2 * q.numel() * esz + 4 * (live_pages + len(positions))
    visible = sum((p + 1 + p + c) * c / 2 for p in positions.tolist())  # causal rows
    flops = 4 * d * h * visible
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_kernels(dev) -> dict[str, dict]:
    """Kernel, plain and library times at the serve phase's shapes in bf16:
    decode over its 4 slots, one prefill chunk of 32 (the engine prefills
    one slot per call) at the last chunk of a 200-token prompt.  The kernel
    is also timed at one key tile per block (``ms_one_tile``: contexts of 16,
    or the first chunk) to split its time into a fixed part and a per-tile
    part."""
    gen = torch.Generator(device=dev).manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, op in dispatch.registry().items():
        chunk = name == "paged_chunk_attention"
        pos = [168] if chunk else DECODE_POS
        args = kernel_inputs(gen, chunk=chunk, dtype=torch.bfloat16, r=len(pos), positions=pos)
        short = kernel_inputs(gen, chunk=chunk, dtype=torch.bfloat16, r=len(pos),
                              positions=[0] if chunk else [15] * len(pos))
        qd, k, v, mask = sdpa_inputs(*args, chunk)
        bound_ms, bound_by = bound(args[0], args[1], args[4], chunk)
        ms, mhz = cuda_ms(lambda: op.kernel(*args))
        out[name] = {
            "ms": ms,
            "ms_one_tile": cuda_ms(lambda: op.kernel(*short))[0],
            "plain_ms": cuda_ms(lambda: op.plain(*args))[0],
            "library_ms": cuda_ms(lambda: sdpa(qd, k, v, attn_mask=mask))[0],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "sm_clock_mhz": mhz,
            "shape": {"q": list(args[0].shape), "pages": list(args[1].shape),
                      "positions": pos, "dtype": "bfloat16"},
        }
        log(f"time {name}: " + json.dumps(out[name]))
    return out


# ---------------------------------------------------------------------------
# Phase 4: serve qwen3-0.6b at full width
# ---------------------------------------------------------------------------


def serve_phase(dev):
    cfg = qwen3_0_6b.CONFIG
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.num_layers}L d{cfg.d_model} {cfg.dtype} "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    scfg = ServeConfig(max_slots=4, num_pages=NUM_PAGES, page_size=BS, max_new_cap=32,
                       prefill_chunk=32, sync_each_step=True)
    requests = synth_requests(8, cfg.vocab_size, [24, 80, 200], [16, 32], [0.0], seed=0)
    # warm-up (CUDA context, cuBLAS handles, the kernel library), not counted
    ServeEngine(params, cfg, scfg).run([dataclasses.replace(requests[0], max_new=2)])
    torch.cuda.synchronize()

    finished = {}
    dispatch.reset_launches()
    summary = serve_run(
        params, cfg, scfg, requests,
        log=lambda ev: finished.update({ev["rid"]: ev["tokens"]}) if ev["event"] == "finish" else None,
    )
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    log("serve run_end: " + json.dumps(summary))
    log("serve launches: " + json.dumps(launches))
    for r in requests:
        if len(finished.get(r.rid, [])) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(finished.get(r.rid, []))} of {r.max_new} tokens")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serve path")
    for r in (requests[1], requests[5]):
        [solo] = ServeEngine(params, cfg, scfg).run([dataclasses.replace(r)])
        if solo.tokens != finished[r.rid]:
            raise AssertionError(f"request {r.rid}: batched tokens differ from solo")
    log("serve: batched == solo for requests 1 and 5")
    short = dataclasses.replace(requests[0], max_new=8)   # 1 prefill chunk, 7 decode steps
    log("profile: " + json.dumps(profile_request(params, cfg, scfg, short)))
    del params
    torch.cuda.empty_cache()
    return summary, launches


def profile_request(params, cfg, scfg, request) -> dict:
    """Where one request's time goes: serve it alone under torch.profiler and
    split the wall time into device busy time (every kernel and copy on the
    card; one stream, so they do not overlap) and the rest, in which the
    card waits for the host.  The profiler's own cost is in the wall time."""
    from torch.profiler import ProfilerActivity, profile

    engine = ServeEngine(params, cfg, scfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run([dataclasses.replace(request)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    attn_ms = sum(e.time_range.elapsed_us() for e in on_card
                  if "paged_attention_kernel" in e.name) / 1e3
    return {
        "rid": request.rid, "prompt": len(request.prompt), "max_new": request.max_new,
        "decode_steps": engine.decode_steps, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_card else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if on_card else "not measured",
        "paged_attention_ms": attn_ms, "device_ops": len(on_card),
    }


# ---------------------------------------------------------------------------
# Phase 5: the slice on the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def greedy(params, cfg, prompt, steps, device, chunk=32, page_size=BS):
    """Chunked prefill of ``prompt`` then ``steps`` greedy decode steps on one
    slot; returns (tokens, fp32 logits of every step on the CPU)."""
    pages = -(-(len(prompt) + steps) // page_size)
    caches = M.init_paged_cache_tree(cfg, 1, pages, page_size, device)
    table = torch.arange(pages, dtype=torch.int32, device=device)[None]
    active = torch.ones(1, dtype=torch.bool, device=device)

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    for cur in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - cur)
        toks = i32(*(prompt[cur:cur + n] + [0] * (chunk - n)))[None]
        logits, _ = M.paged_prefill_chunk(
            params, cfg, toks, caches, PagedView(table, i32(cur), active), lengths=i32(n))
    rows = [logits[0, 0]]
    tokens = [int(rows[-1].argmax())]
    for i in range(steps):
        view = PagedView(table, i32(len(prompt) + i), active)
        logits, _ = M.paged_decode_step(params, cfg, i32(tokens[-1])[None], caches, view)
        rows.append(logits[0, 0])
        tokens.append(int(rows[-1].argmax()))
    return tokens, torch.stack(rows).cpu()


def slice_phase(dev):
    cfg = dataclasses.replace(qwen3_0_6b.CONFIG, dtype="float32")
    t0 = time.perf_counter()
    cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
    gpu_params = _tree_to(cpu_params, dev)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=40).tolist()
    dispatch.reset_launches()
    gpu_tokens, gpu_logits = greedy(gpu_params, cfg, prompt, 8, dev)
    launches = dispatch.launch_counts()
    if min(launches.values()) <= 0:
        raise AssertionError(f"fp32 card run skipped a kernel: {launches}")
    cpu_tokens, cpu_logits = greedy(cpu_params, cfg, prompt, 8, torch.device("cpu"))
    err = (gpu_logits - cpu_logits).abs().max().item()
    log(f"slice fp32: card tokens {gpu_tokens}, cpu tokens {cpu_tokens}, "
        f"max logit diff {err:.3e} (atol {LOGIT_ATOL:g}), {time.perf_counter() - t0:.1f} s")
    if gpu_tokens != cpu_tokens:
        raise AssertionError("card and CPU greedy tokens differ")
    if not (torch.isfinite(gpu_logits).all() and err <= LOGIT_ATOL):
        raise AssertionError("card and CPU logits differ beyond tolerance")
    return err


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


# ---------------------------------------------------------------------------


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    paged_attention.library()
    for name, (secs, report) in build.BUILD_LOG.items():
        log(f"build {name}.cu: {secs:.1f} s\n{report.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    errors = check_kernels(dev)
    timings = time_kernels(dev)
    summary, launches = serve_phase(dev)
    slice_err = slice_phase(dev)

    kernels = []
    for name, op in dispatch.registry().items():
        t = timings[name]
        kernels.append({
            "name": name, "route": op.route, "source": op.source, "replaces": op.replaces,
            "launches": launches[name], "max_abs_err": errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(json.dumps({"summary": {k: summary[k] for k in (
        "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "step_p50_s", "decode_steps", "wall_s")},
        "slice_max_logit_diff": slice_err}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
