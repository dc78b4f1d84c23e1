#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. print the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build the CUDA kernels from ``src/repro_torch/csrc``, one ``nvcc`` per
   source, all started together, and print the build seconds and
   ``ptxas``'s register and shared-memory report;
3. hold each kernel against its plain PyTorch version on the card: the
   paged kernels at qwen3-0.6b shapes (H 16, KV 8, D 128, BS 16, R 4, C 32;
   causal and local with window 64, bf16 and fp32, plus ragged heads H 6 /
   KV 4); flash attention forward and backward at the paper model's shape
   (B 4, S 1024, H = KV = 16, D 48) and at GQA 16/8 with D 128, ragged 6/4,
   causal, local (window 64) and full, bf16 and fp32; the NoLoCo outer
   update on a leaf the size of the paper model's stacked embedding
   (4 × 128,000 × 768).  Then time kernel, plain version and the library
   yardstick (``scaled_dot_product_attention`` forward and backward, which
   the port never calls) at the shapes the main paths give them;
4. serve qwen3-0.6b at its published width in bf16 on weights from seed 0:
   8 requests, 4 slots, prompts 24/80/200, generation 16/32, 128 pages of
   16, chunked prefill 32, greedy.  Launch counts are zeroed just before the
   run and read just after; both kernels must have launched.  Two requests
   are decoded again alone and must give the same tokens, and one short
   request is served under ``torch.profiler`` to split its wall time into
   device busy time and the rest;
5. run one 40-token prompt plus 8 greedy decode steps of the full-width
   model in fp32 on the card (kernels) and on the CPU (plain versions), on
   the same weights: identical tokens, logits within fp32 tolerance;
6. train paper-small-125m at its published width in bf16 through
   ``run_training``: NoLoCo, 4 replicas, per-replica batch 4, seq 1024,
   5 inner steps, 10 steps (2 outer syncs).  Launch counts are zeroed just
   before and read just after, and must equal the counts the config implies
   (per step: one forward per layer, one more under remat, one backward per
   layer; per sync: one update per parameter leaf).  Every loss is finite,
   the last is below the first, the replicas' weight std is above 0.  Then
   the outer step is timed alone and one more inner step is profiled for
   the device's busy share;
7. train ``paper-small-125m.reduced()`` in fp32 (NoLoCo, 4 replicas, 2
   outer rounds) on the card and on the CPU from the same initial state:
   identical partner tables, per-step losses within 1e-4 relative, final
   weight std within 1e-3 relative.

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

from repro_torch.comm import bytes_model  # noqa: E402
from repro_torch.configs import paper_llama, qwen3_0_6b  # noqa: E402
from repro_torch.data import LoaderConfig, shard_iterator  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.serve import serve_run, synth_requests  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.attention import PagedView  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train import adapters  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and per-type compute.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances of the kernel checks.  fp32: the kernel and the plain version
# sum in different orders.  bf16: both round an fp32 result to bf16, so they
# may differ by one bf16 ulp of the output (2**-6 for |out| in [2, 4)).
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Whole-model fp32 logits, card vs CPU: 28 layers of sums in another order.
LOGIT_ATOL = 2e-3
# bf16 attention gradients also get a relative tolerance: dK/dV sum over
# every query row and grow with it, while bf16 rounding is relative.
GRAD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2e-2}
# Training, card against CPU (fp32): per-step losses and final weight std.
LOSS_RTOL, WSTD_RTOL = 1e-4, 1e-3
PAGED = ("paged_attention", "paged_chunk_attention")
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "noloco_update")
# The paper model's training shapes: 4 replicas × batch 4 folded into B.
PAPER = dict(b=16, s=1024, h=16, kv=16, d=48)

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
    for name in PAGED:
        op = dispatch.registry()[name]
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


def flash_inputs(gen, b, s, h, kv, d, dtype):
    dev = gen.device
    shapes = [(b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)]
    return [torch.randn(sh, generator=gen, device=dev).to(dtype) for sh in shapes]


def _close(got, want, atol, rtol, what):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= atol + rtol * want.float().abs()).all())
    return diff.max().item(), ok


def check_train_kernels(dev) -> dict[str, float]:
    """Flash forward (o and lse) and backward, and the outer update, against
    their plain versions on the card."""
    gen = torch.Generator(device=dev).manual_seed(3)
    reg = dispatch.registry()
    errors = {name: 0.0 for name in TRAIN_KERNELS}
    cases = [(4, 1024, 16, 16, 48, "causal", 0), (2, 300, 16, 8, 128, "causal", 0),
             (2, 200, 6, 4, 48, "causal", 0), (2, 333, 16, 16, 48, "local", 64),
             (2, 257, 16, 8, 64, "full", 0)]
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, kv, d, mode, window in cases:
            q, k, v, do = flash_inputs(gen, b, s, h, kv, d, dtype)
            o, lse = reg["flash_attention"].kernel(q, k, v, mode=mode, window=window)
            grads = reg["flash_attention_bwd"].kernel(q, k, v, o, lse, do, mode=mode, window=window)
            torch.cuda.synchronize()
            o_want, lse_want = reg["flash_attention"].plain(q, k, v, mode=mode, window=window)
            g_want = reg["flash_attention_bwd"].plain(q, k, v, o, lse, do, mode=mode, window=window)
            results = [("flash_attention", *_close(o, o_want, ATOL[dtype], 0, "o")),
                       ("flash_attention", *_close(lse, lse_want, 1e-4, 1e-5, "lse"))]
            results += [("flash_attention_bwd", *_close(g, w, ATOL[dtype], GRAD_RTOL[dtype], n))
                        for g, w, n in zip(grads, g_want, ("dq", "dk", "dv"))]
            for name, err, ok in results:
                errors[name] = max(errors[name], err)
                if not ok:
                    raise AssertionError(
                        f"{name} disagrees with its plain version: {str(dtype)[6:]} B{b} S{s} "
                        f"H{h}/KV{kv} D{d} {mode}: max_abs_err {err:.3e}")
            log(f"check flash {str(dtype)[6:]} B{b} S{s} H{h}/KV{kv} D{d} {mode}: "
                + ", ".join(f"{n} {e:.3e}" for n, e, _ in results) + " ok")
    op = reg["noloco_update"]
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9186)
    for dtype, mant in ((torch.bfloat16, 7), (torch.float32, 23)):
        args = [torch.randn((4, 128_000, 768), generator=gen, device=dev).to(dtype) for _ in range(4)]
        got = op.kernel(*args, **coef)
        torch.cuda.synchronize()
        want = op.plain(*args, **coef)
        for g, w in zip(got, want):   # within one ulp of the dtype
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"noloco_update: {g.dtype} {tuple(g.shape)}")
            ulp = torch.exp2(torch.floor(torch.log2(w.float().abs().clamp_min(1e-30))) - mant)
            diff = (g.float() - w.float()).abs()
            err = diff.max().item()
            errors["noloco_update"] = max(errors["noloco_update"], err)
            if not bool((diff <= ulp).all()):
                raise AssertionError(f"noloco_update {dtype}: off by more than 1 ulp ({err:.3e})")
        log(f"check noloco_update {str(dtype)[6:]} (4, 128000, 768): max_abs_err "
            f"{errors['noloco_update']:.3e} (1 ulp) ok")
        del args, got, want
    return errors


def flash_bound(b, s, h, kv, d, esz, backward):
    """Least time for causal attention: q, k, v (and o, dO) read once, the
    outputs written once, against the flops of the visible (row, key) pairs:
    4·D each forward (QKᵀ and PV), 10·D backward (recomputed QKᵀ, dO·Vᵀ, dV,
    dK, dQ), at the bf16 tensor-core peak."""
    qo, kv_elems, rows = b * s * h * d, b * s * kv * d, b * h * s
    if backward:   # read q, k, v, o, dO, lse; write dq, dk, dv
        nbytes = (4 * qo + 4 * kv_elems) * esz + 4 * rows
    else:          # read q, k, v; write o, lse
        nbytes = (2 * qo + 2 * kv_elems) * esz + 4 * rows
    pairs = b * h * s * (s + 1) / 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (10 if backward else 4) * d * pairs / PEAK_FLOPS[torch.bfloat16]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_train_kernels(dev) -> dict[str, dict]:
    """Kernel, plain and library times at the training path's shapes in
    bf16: attention at the paper model's (R·B 16, S 1024, H = KV = 16, D 48,
    causal), the outer update on the stacked embedding leaf, the largest of
    the path (4 × 128,000 × 768)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    reg = dispatch.registry()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, do = flash_inputs(gen, *PAPER.values(), torch.bfloat16)
    o, lse = reg["flash_attention"].kernel(q, k, v)
    # SDPA takes (B, H, S, D); its backward is timed from one retained graph
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    ot = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    out = {}
    for name, backward in (("flash_attention", False), ("flash_attention_bwd", True)):
        op = reg[name]
        args = (q, k, v, o, lse, do) if backward else (q, k, v)
        lib = ((lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
               if backward else (lambda: sdpa(qt, kt, vt, is_causal=True)))
        bound_ms, bound_by = flash_bound(*PAPER.values(), 2, backward)
        ms, mhz = cuda_ms(lambda: op.kernel(*args), reps=30)
        out[name] = {"ms": ms, "plain_ms": cuda_ms(lambda: op.plain(*args), reps=10)[0],
                     "library_ms": cuda_ms(lib, reps=30)[0], "bound_ms": bound_ms,
                     "bound_by": bound_by, "sm_clock_mhz": mhz,
                     "shape": {"q": list(q.shape), "kv": list(k.shape), "mode": "causal",
                               "dtype": "bfloat16"}}
        log(f"time {name}: " + json.dumps(out[name]))
    del qt, kt, vt, ot
    args = [torch.randn((4, 128_000, 768), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(4)]
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9186)
    op = reg["noloco_update"]
    n = args[0].numel()
    t_bytes, t_ops = 6 * n * 2 / HBM_BYTES_PER_S, 8 * n / PEAK_FLOPS[torch.float32]
    ms, mhz = cuda_ms(lambda: op.kernel(*args, **coef), reps=30)
    out["noloco_update"] = {
        "ms": ms, "plain_ms": cuda_ms(lambda: op.plain(*args, **coef), reps=10)[0],
        "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "sm_clock_mhz": mhz,
        "shape": {"leaf": [4, 128_000, 768], "dtype": "bfloat16"}}
    log("time noloco_update: " + json.dumps(out["noloco_update"]))
    return out


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
    for name in PAGED:
        op = dispatch.registry()[name]
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
    for name in PAGED:
        if launches[name] <= 0:
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
    if min(launches[name] for name in PAGED) <= 0:
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


# ---------------------------------------------------------------------------
# Phase 6: train paper-small-125m at full width
# ---------------------------------------------------------------------------

TRAIN = dict(method="noloco", replicas=4, per_replica_batch=4, seq_len=1024, steps=10,
             inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0)


def expected_launches(cfg, run: dict, outer_syncs: int) -> dict[str, int]:
    """Launches the config implies: per inner step one attention forward per
    layer (twice under remat: the backward pass runs the layer again) and
    one backward per layer; per outer sync one update per parameter leaf."""
    leaves = len(tree_leaves(bytes_model.abstract_params(cfg)))
    return {
        "flash_attention": run["steps"] * cfg.num_layers * (2 if cfg.remat else 1),
        "flash_attention_bwd": run["steps"] * cfg.num_layers,
        "noloco_update": outer_syncs * leaves,
    }


def train_phase(dev):
    cfg = paper_llama.SMALL
    log(f"train: {cfg.name} {cfg.num_layers}L d{cfg.d_model} H{cfg.num_heads} "
        f"vocab {cfg.vocab_size} {cfg.dtype} remat={cfg.remat}: " + json.dumps(TRAIN))
    jsonl = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_train.jsonl")
    os.makedirs(os.path.dirname(jsonl), exist_ok=True)
    if os.path.exists(jsonl):
        os.remove(jsonl)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = train_cli.run_training(cfg, device="cuda", log_jsonl=jsonl, **TRAIN)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_launches(cfg, TRAIN, res["outer_syncs"])
    log("train launches: " + json.dumps({k: launches[k] for k in TRAIN_KERNELS})
        + " expected " + json.dumps(want))
    losses = res["losses"]
    log("train losses: " + json.dumps(losses))
    if res["outer_syncs"] != 2 or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"launch counts {launches} differ from the config's {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not go down: {losses}")
    if not res["final_weight_std"] > 0:
        raise AssertionError("replicas identical after the outer syncs")
    steps = [e for e in map(json.loads, open(jsonl)) if e["event"] == "step"]
    m = TRAIN["inner_steps"]
    # steps without a sync; step 1 warms up.  A step's dt also holds the
    # device tail of the previous step's outer sync (the next batch's copy
    # to the card waits for it).
    inner = sorted(e["dt_s"] * 1e3 for e in steps[1:] if e["step"] % m)
    p50 = statistics.median(inner)
    tokens = TRAIN["replicas"] * TRAIN["per_replica_batch"] * TRAIN["seq_len"]
    prof = profile_steps(cfg, res["state"], dev)
    summary = {
        "inner_step_p50_ms": p50, "inner_step_p99_ms": inner[min(len(inner) - 1,
                                                                int(0.99 * len(inner)))],
        "inner_step_samples": len(inner),
        "tokens_per_s_steady": tokens / (p50 / 1e3), "tokens_per_s_run": res["tokens_per_s"],
        "wall_s": res["wall_s"], "peak_memory_gb": peak_gb,
        "final_weight_std": res["final_weight_std"], "loss_first": losses[0],
        "loss_last": losses[-1], "comm_bytes": res["comm_bytes"],
        "blocking_bytes": res["blocking_bytes"], **prof,
    }
    log("train summary: " + json.dumps(summary))
    del res
    torch.cuda.empty_cache()
    return summary, launches


def profile_steps(cfg, state, dev) -> dict:
    """On the trained state, after the launch counts were read: the outer
    step timed alone (synchronised before and after, median of 3), and one
    more inner step under torch.profiler for the device's busy share of its
    wall time and the attention kernels' share of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    tcfg = train_cli.method_config("noloco", inner_lr=3e-3, total_steps=10, warmup=1, inner_steps=5)
    program = adapters.GossipProgram(cfg, tcfg, replicas=TRAIN["replicas"], device=dev)
    batch = next(shard_iterator(LoaderConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
        per_replica_batch=TRAIN["per_replica_batch"], replicas=TRAIN["replicas"]), start_step=10))
    outer_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.trainer.outer_step(state)   # pairing from the outer step counter
        torch.cuda.synchronize()
        outer_ms.append((time.perf_counter() - t0) * 1e3)
    state, _ = program.inner_step(state, batch)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = program.inner_step(state, batch)
        float(metrics["loss"].mean())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    by_name: dict[str, float] = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash_ms = sum(t for n, t in by_name.items() if "flash_" in n)
    return {
        "outer_step_ms": statistics.median(outer_ms), "outer_step_samples_ms": outer_ms,
        "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_card else "not measured",
        "device_busy_share": busy_ms / wall_ms if on_card else "not measured",
        "flash_kernels_ms": flash_ms, "device_ops": len(on_card),
        "top_device_ops_ms": [[n[:60], t] for n, t in top],
    }


# ---------------------------------------------------------------------------
# Phase 7: training on the card against the CPU
# ---------------------------------------------------------------------------


def train_parity_phase(dev):
    cfg = paper_llama.SMALL.reduced(dtype="float32", remat=False)
    run = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=64, steps=10,
               inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0)
    t0 = time.perf_counter()
    dispatch.reset_launches()
    card = train_cli.run_training(cfg, device="cuda", **run)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    cpu = train_cli.run_training(cfg, device="cpu", **run)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    wstd_rel = abs(card["final_weight_std"] - cpu["final_weight_std"]) / cpu["final_weight_std"]
    same_pairs = len(card["partners"]) == 2 and all(
        np.array_equal(a, b) for a, b in zip(card["partners"], cpu["partners"]))
    out = {"loss_max_rel_diff": rel, "weight_std_rel_diff": wstd_rel,
           "partner_tables_identical": same_pairs,
           "partners": [p.tolist() for p in card["partners"]],
           "launches": {k: launches[k] for k in TRAIN_KERNELS},
           "seconds": time.perf_counter() - t0}
    log("train fp32 card vs cpu: " + json.dumps(out))
    if not same_pairs:
        raise AssertionError("card and CPU runs paired replicas differently")
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"fp32 card training skipped a kernel: {launches}")
    if not (rel <= LOSS_RTOL and wstd_rel <= WSTD_RTOL):
        raise AssertionError(f"card and CPU training differ: losses {rel:.3e}, wstd {wstd_rel:.3e}")
    return out


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
    build.build_all()
    for name, (secs, report) in build.BUILD_LOG.items():
        log(f"build {name}.cu: {secs:.1f} s\n{report.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    errors = {**check_kernels(dev), **check_train_kernels(dev)}
    timings = {**time_kernels(dev), **time_train_kernels(dev)}
    summary, launches = serve_phase(dev)
    slice_err = slice_phase(dev)
    train_summary, train_launches = train_phase(dev)
    parity = train_parity_phase(dev)
    launches.update({k: train_launches[k] for k in TRAIN_KERNELS})

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
        "slice_max_logit_diff": slice_err, "train": train_summary,
        "train_card_vs_cpu": {k: parity[k] for k in (
            "loss_max_rel_diff", "weight_std_rel_diff", "partner_tables_identical")},
        "seconds": time.perf_counter() - t0}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
