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
   causal, local (window 64) and full, D 128 and 256 at S 1024, D 36, bf16
   and fp32, each line naming the kernels that served it (bf16 with
   D % 8 == 0 the tensor-core ones, the rest the CUDA-core ones); the NoLoCo outer
   update on a leaf the size of the paper model's stacked embedding
   (4 × 128,000 × 768).  Then time kernel, plain version and the library
   yardstick (``scaled_dot_product_attention`` forward and backward, which
   the port never calls) at the shapes the main paths give them, the flash
   pair also on the kept CUDA-core kernels in bf16;
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
   weight std within 1e-3 relative;
8. (with phase 3) hold the int8 quantize and dequantize kernels against
   their plain versions bit for bit: fp32 and bf16 payloads, ragged tails,
   constant chunks, chunk magnitudes from 1e-30 to 1e4, CHUNK 1024, 3000
   and 7, and the full-width payload (4 replicas × 366,477,312 bf16 values);
   time both there with L2 flushed, beside the plain versions and the bound;
9. train paper-small-125m at full width as in phase 6 with the int8 wire
   (``codec="int8"``): launch counts as the design implies (one quantize
   and one dequantize per float buffer of the payload per sync, all four
   replicas in one launch), ``comm_bytes`` equal to the byte model's, the
   losses and inner-step p50, and the outer step timed alone with the int8
   and the plain wire in turns on the same state;
10. phase 7 with the int8 wire: identical partner tables, losses within
    1e-4 relative (the weight std is reported: the int8 wire amplifies the
    last-bit differences of card and CPU);
11. checkpoint and resume on the card, reduced model in fp32 with the int8
    wire: 6 steps saving every 3, resumed to 12, against 12 uninterrupted
    steps: identical losses and bit-identical final θ, φ and δ; the save
    and the restore of that state timed;
12. promote replica 1's φ from that checkpoint and serve 4 greedy requests
    through ``repro_torch.launch.serve --ckpt`` on the card (paged kernels,
    launch counts > 0) and on the CPU: identical tokens;
13. (with phase 3) hold the recurrent families' kernels against their plain
    versions: the SSD chunk kernel at the serve shape (Q 32, H 32, P 64,
    N 128), at Q 16, 64 and 128 and on ragged chunks with dt = 0 pad rows;
    the RG-LRU scan at (1, 32, 4096) and at widths and lengths that are no
    multiple of 32; both decode steps at the serve shapes and ragged ones,
    their states bit for bit; and the paged kernels at recurrentgemma-9b's
    local layers (H 16, KV 1, D 256, window 2048) over contexts longer than
    the window.  Then time the four kernels at the serve shapes and the two
    scans also at the training slice's shapes, and the paged kernels at
    recurrentgemma-9b's shape;
14. serve mamba2-370m and then recurrentgemma-9b at published width in bf16
    with the phase-4 mix, each model freed before the next: tokens/s, TTFT
    and decode-step p50/p99, peak memory, every request's budget, batched
    == solo, and launch counts equal to the design (per prefill chunk and
    per decode step: one scan or decode step per recurrent layer, one paged
    kernel per attention layer);
15. both families' ``reduced()`` configs in fp32 on the card and on the CPU
    from the same weights, prompts of 80 and 200 tokens (the reduced window
    is 64): identical tokens, logits within 2e-3.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.checkpoint import ckpt as ckpt_lib  # noqa: E402
from repro_torch.comm import CommConfig, bytes_model, payload  # noqa: E402
from repro_torch.configs import mamba2_370m, paper_llama, qwen3_0_6b, recurrentgemma_9b  # noqa: E402
from repro_torch.data import LoaderConfig, shard_iterator  # noqa: E402
from repro_torch.kernels import build, dispatch, flash_attention, ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.serve import serve_run, synth_requests  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.attention import PagedView  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train import adapters  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and per-type compute.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# The special-function units' exp2 rate: 16 per clock per SM, 132 SMs.
EX2_PER_CLOCK = 16 * 132

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
INT8 = ("int8_quantize", "int8_dequantize")
# One replica's (Δ, φ) payload of paper-small-125m at full width: its bf16
# buffer (the fp32 one holds the 76,800 norm values).
PAYLOAD_BF16 = 366_477_312
# The paper model's training shapes: 4 replicas × batch 4 folded into B.
PAPER = dict(b=16, s=1024, h=16, kv=16, d=48)

RECURRENT = ("ssd_chunk", "rglru_scan", "rglru_decode", "ssd_decode")
# SSD chunk kernel against its plain version: fp32 sums of up to Q·N
# products in another order.
SSD_ATOL = SSD_RTOL = 1e-4

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
             (2, 257, 16, 8, 64, "full", 0), (1, 1024, 8, 8, 128, "causal", 0),
             (1, 1024, 4, 2, 256, "causal", 0), (2, 300, 8, 4, 36, "causal", 0)]
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
            log(f"check flash {str(dtype)[6:]} B{b} S{s} H{h}/KV{kv} D{d} {mode} "
                f"path {flash_attention.path_for(dtype, d)}: "
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


def flash_bound(b, s, h, kv, d, esz, backward, sm_mhz):
    """Least time for causal attention, the largest of three: q, k, v (and
    o, dO) read once and the outputs written once; the flops of the visible
    (row, key) pairs, 4·D each forward (QKᵀ and PV), 10·D backward
    (recomputed QKᵀ, dO·Vᵀ, dV, dK, dQ), at the bf16 tensor-core peak; one
    exp2 per visible pair, forward and backward alike (the function needs
    one; the tensor-core backward's dQ blocks recompute P and take a second,
    a cost of that design and not of the function), at the special-function
    units' rate at the measured SM clock.  Returns (ms, "bytes" or
    "operations", which of the three)."""
    qo, kv_elems, rows = b * s * h * d, b * s * kv * d, b * h * s
    if backward:   # read q, k, v, o, dO, lse; write dq, dk, dv
        nbytes = (4 * qo + 4 * kv_elems) * esz + 4 * rows
    else:          # read q, k, v; write o, lse
        nbytes = (2 * qo + 2 * kv_elems) * esz + 4 * rows
    pairs = b * h * s * (s + 1) / 2
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "flops": (10 if backward else 4) * d * pairs / PEAK_FLOPS[torch.bfloat16],
             "exponentials": pairs / (EX2_PER_CLOCK * sm_mhz * 1e6)}
    what = max(times, key=times.get)
    return times[what] * 1e3, ("bytes" if what == "bytes" else "operations"), what


def flash_cuda_core(q, k, v, o=None, lse=None, do=None):
    """The kept CUDA-core flash kernels on the paper shape's causal inputs,
    whatever their type: the library's ``*_cuda_core`` entry points, which
    the port's wrappers never call (they let the source choose by type and
    head dim).  Forward with three tensors, backward with six."""
    lib = flash_attention.library()
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dtype, stream = (0 if q.dtype == torch.float32 else 1), torch.cuda.current_stream().cuda_stream
    if o is None:
        o, lse = torch.empty_like(q), torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_fwd_cuda_core(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, sq, sk, h, kvh, d, 0, 0, 1.0 / math.sqrt(d), stream)
        outs = (o, lse)
    else:
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        err = lib.flash_attention_bwd_cuda_core(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), *(t.data_ptr() for t in outs), b, sq, sk, h, kvh, d, 0, 0,
            1.0 / math.sqrt(d), stream, None)
    if err:
        raise RuntimeError(f"CUDA-core flash launch failed: cudaError_t {err}")
    return outs


def time_train_kernels(dev) -> dict[str, dict]:
    """Kernel, plain and library times at the training path's shapes in
    bf16: attention at the paper model's (R·B 16, S 1024, H = KV = 16, D 48,
    causal) on the path the main path takes (tensor cores) and on the kept
    CUDA-core kernels (``cuda_core_ms``), the outer update on the stacked
    embedding leaf, the largest of the path (4 × 128,000 × 768)."""
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
        ms, mhz = cuda_ms(lambda: op.kernel(*args), reps=30)
        bound_ms, bound_by, bound_what = flash_bound(*PAPER.values(), 2, backward, mhz)
        out[name] = {"ms": ms, "path": flash_attention.path_for(q.dtype, PAPER["d"]),
                     "cuda_core_ms": cuda_ms(lambda: flash_cuda_core(*args), reps=10)[0],
                     "plain_ms": cuda_ms(lambda: op.plain(*args), reps=10)[0],
                     "library_ms": cuda_ms(lib, reps=30)[0], "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_by_detail": bound_what, "sm_clock_mhz": mhz,
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


SERVE_MIX = dict(n=8, prompt_lens=[24, 80, 200], gen_lens=[16, 32])


def serve_phase(dev, cfg=qwen3_0_6b.CONFIG, expected=None):
    """Serve ``cfg`` at published width on weights from seed 0 with the
    phase-4 mix.  ``expected(chunk_calls, decode_steps)`` gives the launch
    count of every kernel the model runs; without it the paged kernels must
    have launched."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.num_layers}L d{cfg.d_model} {cfg.dtype} "
        f"initialised in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of weights")
    scfg = ServeConfig(max_slots=4, num_pages=NUM_PAGES, page_size=BS, max_new_cap=32,
                       prefill_chunk=32, sync_each_step=True)
    requests = synth_requests(SERVE_MIX["n"], cfg.vocab_size, SERVE_MIX["prompt_lens"],
                              SERVE_MIX["gen_lens"], [0.0], seed=0)
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
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve {cfg.name} run_end: " + json.dumps(summary))
    log(f"serve {cfg.name} launches: " + json.dumps(launches))
    for r in requests:
        if len(finished.get(r.rid, [])) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(finished.get(r.rid, []))} of {r.max_new} tokens")
    if expected is None:
        for name in PAGED:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the serve path")
    else:
        chunk_calls = sum(-(-len(r.prompt) // scfg.prefill_chunk) for r in requests)
        want = expected(chunk_calls, summary["decode_steps"])
        log(f"serve {cfg.name} launches expected ({chunk_calls} chunk calls, "
            f"{summary['decode_steps']} decode steps): " + json.dumps(want))
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"{cfg.name}: launch counts {launches} differ from the design's {want}")
    for r in (requests[1], requests[5]):
        [solo] = ServeEngine(params, cfg, scfg).run([dataclasses.replace(r)])
        if solo.tokens != finished[r.rid]:
            raise AssertionError(f"{cfg.name} request {r.rid}: batched tokens differ from solo")
    log(f"serve {cfg.name}: batched == solo for requests 1 and 5")
    short = dataclasses.replace(requests[0], max_new=8)   # 1 prefill chunk, 7 decode steps
    summary["profile"] = profile_request(params, cfg, scfg, short)
    log(f"profile {cfg.name}: " + json.dumps(summary["profile"]))
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
    recurrent_ms = sum(e.time_range.elapsed_us() for e in on_card
                       if any(k in e.name for k in ("ssd_chunk_kernel", "rglru_scan_kernel",
                                                     "rglru_decode_kernel", "ssd_decode_kernel"))) / 1e3
    return {
        "rid": request.rid, "prompt": len(request.prompt), "max_new": request.max_new,
        "decode_steps": engine.decode_steps, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_card else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if on_card else "not measured",
        "paged_attention_ms": attn_ms, "recurrent_kernels_ms": recurrent_ms,
        "device_ops": len(on_card),
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


def expected_launches(cfg, run: dict, outer_syncs: int, codec: str = "none") -> dict[str, int]:
    """Launches the config implies: per inner step one attention forward per
    layer (twice under remat: the backward pass runs the layer again) and
    one backward per layer; per outer sync one update per parameter leaf
    and, on the int8 wire, one quantize and one dequantize per float buffer
    of the fused (Δ, φ) payload (bf16 and fp32 here), every replica in the
    same launch."""
    tree = bytes_model.abstract_params(cfg)
    buffers = len(payload.make_spec((tree, tree)).buffers) if codec == "int8" else 0
    return {
        "flash_attention": run["steps"] * cfg.num_layers * (2 if cfg.remat else 1),
        "flash_attention_bwd": run["steps"] * cfg.num_layers,
        "noloco_update": outer_syncs * len(tree_leaves(tree)),
        "int8_quantize": outer_syncs * buffers,
        "int8_dequantize": outer_syncs * buffers,
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
    log("train launches: " + json.dumps({k: launches[k] for k in want})
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
    # the flash kernels one by one: the forward, the backward's Di pre-pass,
    # dK/dV and dQ blocks (ms over the step, launches)
    flash_split: dict[str, list] = {}
    for e in on_card:
        kind = re.search(r"flash_\w*?kernel", e.name)
        if kind:
            row = flash_split.setdefault(kind.group(0), [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    return {
        "outer_step_ms": statistics.median(outer_ms), "outer_step_samples_ms": outer_ms,
        "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_card else "not measured",
        "device_busy_share": busy_ms / wall_ms if on_card else "not measured",
        "flash_kernels_ms": flash_ms, "flash_kernels_split": flash_split,
        "device_ops": len(on_card),
        "top_device_ops_ms": [[n[:60], t] for n, t in top],
    }


# ---------------------------------------------------------------------------
# Phase 7: training on the card against the CPU
# ---------------------------------------------------------------------------


def train_parity_phase(dev, codec: str = "none"):
    """Phase 7, and phase 10 with ``codec="int8"``: there the weight std is
    reported, not held to WSTD_RTOL (a last-bit difference of card and CPU
    can move a chunk's min or max, and so all of its codes)."""
    cfg = paper_llama.SMALL.reduced(dtype="float32", remat=False)
    run = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=64, steps=10,
               inner_steps=5, eval_every=0, inner_lr=3e-3, seed=0, codec=codec)
    kernels = TRAIN_KERNELS + (INT8 if codec == "int8" else ())
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
           "launches": {k: launches[k] for k in kernels},
           "seconds": time.perf_counter() - t0}
    log(f"train fp32 card vs cpu{'' if codec == 'none' else ' ' + codec}: " + json.dumps(out))
    if not same_pairs:
        raise AssertionError("card and CPU runs paired replicas differently")
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"fp32 card training skipped a kernel: {launches}")
    if not (rel <= LOSS_RTOL and (codec != "none" or wstd_rel <= WSTD_RTOL)):
        raise AssertionError(f"card and CPU training differ: losses {rel:.3e}, wstd {wstd_rel:.3e}")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the int8 codec kernels against their plain versions, and timed
# ---------------------------------------------------------------------------


def int8_payload(gen, rows, n, chunk, dtype):
    """(rows, n) values whose chunks have magnitudes from 1e-30 to 1e4 and
    offsets of their own size; the first chunk of each row is constant."""
    dev = gen.device
    nb = -(-n // chunk)
    mag = torch.pow(10.0, torch.empty((rows, nb, 1), device=dev).uniform_(-30, 4, generator=gen))
    off = torch.randn((rows, nb, 1), generator=gen, device=dev)
    x = (torch.randn((rows, nb, chunk), generator=gen, device=dev) + off) * mag
    x = x.reshape(rows, -1)[:, :n].contiguous()
    x[:, :min(chunk, n)] = 3.25
    return x.to(dtype)


def check_int8_kernels(dev) -> dict[str, float]:
    """Both kernels bit-identical to their plain versions (q, scale, lo and
    the dequantized values in fp32 and bf16), the dequantize reading the
    codes through the wire's row stride as the codec gives them."""
    gen = torch.Generator(device=dev).manual_seed(5)
    reg = dispatch.registry()
    errors = {name: 0.0 for name in INT8}
    cases = [(rows, n, chunk, dtype) for dtype in (torch.float32, torch.bfloat16)
             for rows, n, chunk in ((4, 8 * 1024 + 17, 1024), (1, 64 * 1024, 1024),
                                    (3, 1000, 7), (2, 9001, 3000))]
    cases.append((4, PAYLOAD_BF16, 1024, torch.bfloat16))
    for rows, n, chunk, dtype in cases:
        full = n == PAYLOAD_BF16
        x = (torch.randn((rows, n), generator=gen, device=dev, dtype=dtype) * 0.02 if full
             else int8_payload(gen, rows, n, chunk, dtype))
        got = reg["int8_quantize"].kernel(x, chunk)
        torch.cuda.synchronize()
        want = reg["int8_quantize"].plain(x, chunk)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        if not all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
                   for g, w in zip(got, want)):
            raise AssertionError(f"int8_quantize differs from its plain version: rows {rows} "
                                 f"n {n} chunk {chunk} {dtype}: max_abs_err {err}")
        errors["int8_quantize"] = max(errors["int8_quantize"], err)
        q, scale, lo = got
        del want
        nc = q.shape[1]
        wire = torch.cat([q.reshape(rows, -1), torch.zeros((rows, 8 * nc), dtype=torch.uint8,
                                                            device=dev)], dim=1)
        strided = wire[:, :nc * chunk].reshape(rows, nc, chunk)
        derr = 0.0
        for out_dtype in ((torch.bfloat16,) if full else (torch.float32, torch.bfloat16)):
            d_got = reg["int8_dequantize"].kernel(strided, scale, lo, n, out_dtype)
            torch.cuda.synchronize()
            d_want = reg["int8_dequantize"].plain(q, scale, lo, n, out_dtype)
            derr = max(derr, (d_got.float() - d_want.float()).abs().max().item())
            if not (d_got.dtype == out_dtype and torch.equal(d_got, d_want)):
                raise AssertionError(f"int8_dequantize differs from its plain version: rows {rows} "
                                     f"n {n} chunk {chunk} -> {out_dtype}: max_abs_err {derr}")
            del d_got, d_want
        errors["int8_dequantize"] = max(errors["int8_dequantize"], derr)
        log(f"check int8 {str(dtype)[6:]} rows {rows} n {n} chunk {chunk}: quantize "
            f"max_abs_err {err}, dequantize max_abs_err {derr} (bit-identical) ok")
        del x, got, q, scale, lo, wire, strided
        torch.cuda.empty_cache()
    return errors


def time_int8_kernels(dev) -> dict[str, dict]:
    """Kernel and plain times at the full-width payload, the bf16 buffer of
    4 replicas × 366,477,312 values in chunks of 1024.  Bounds count the
    bytes the kernels move: quantize reads each bf16 value once and writes
    its code plus 8 bytes per chunk; dequantize reads each code and the 8
    bytes per chunk and writes the bf16 value.  No single PyTorch call
    computes either function (library: none)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    reg = dispatch.registry()
    rows, n, chunk = 4, PAYLOAD_BF16, 1024
    x = torch.randn((rows, n), generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
    q, scale, lo = reg["int8_quantize"].kernel(x, chunk)
    nc = q.shape[1]
    elems = rows * nc * chunk
    work = {
        # (bytes moved, fp32 operations): sub, div, rint, 2 clamps, min, max per value
        "int8_quantize": (rows * n * 2 + elems + 8 * rows * nc, 7 * elems,
                          (x, chunk)),
        # one fused multiply-add per value
        "int8_dequantize": (rows * n + 8 * rows * nc + rows * n * 2, 2 * rows * n,
                            (q, scale, lo, n, torch.bfloat16)),
    }
    out = {}
    for name, (nbytes, flops, args) in work.items():
        op = reg[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
        ms, mhz = cuda_ms(lambda: op.kernel(*args), reps=20)
        out[name] = {"ms": ms, "plain_ms": cuda_ms(lambda: op.plain(*args), reps=3)[0],
                     "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "sm_clock_mhz": mhz,
                     "shape": {"x": [rows, n], "chunk": chunk, "dtype": "bfloat16"}}
        log(f"time {name}: " + json.dumps(out[name]))
    del x, q, scale, lo, work
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 9: full-width training over the int8 wire
# ---------------------------------------------------------------------------


def time_outer(cfg, state, dev, reps: int = 3) -> dict[str, list[float]]:
    """The outer step alone (synchronised before and after) on one state,
    with the plain and the int8 wire in turns."""
    times: dict[str, list[float]] = {"none": [], "int8": []}
    for _ in range(reps):
        for codec in times:
            tcfg = train_cli.method_config("noloco", inner_lr=3e-3, total_steps=10, warmup=1,
                                           inner_steps=5, comm=CommConfig(codec=codec))
            program = adapters.GossipProgram(cfg, tcfg, replicas=TRAIN["replicas"], device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            program.trainer.outer_step(state)   # pairing from the outer step counter
            torch.cuda.synchronize()
            times[codec].append((time.perf_counter() - t0) * 1e3)
    return times


def int8_train_phase(dev, none_summary: dict):
    cfg = paper_llama.SMALL
    log("train int8: " + json.dumps({**TRAIN, "codec": "int8"}))
    jsonl = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_train_int8.jsonl")
    os.makedirs(os.path.dirname(jsonl), exist_ok=True)
    if os.path.exists(jsonl):
        os.remove(jsonl)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = train_cli.run_training(cfg, device="cuda", codec="int8", log_jsonl=jsonl, **TRAIN)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_launches(cfg, TRAIN, res["outer_syncs"], codec="int8")
    log("train int8 launches: " + json.dumps({k: launches[k] for k in want})
        + " expected " + json.dumps(want))
    cost = bytes_model.outer_step_cost(bytes_model.abstract_params(cfg), CommConfig(codec="int8"),
                                       world=TRAIN["replicas"])
    losses = res["losses"]
    log("train int8 losses: " + json.dumps(losses))
    if res["outer_syncs"] != 2 or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"launch counts {launches} differ from the design's {want}")
    if res["comm_bytes"] != res["outer_syncs"] * cost.payload_bytes:
        raise AssertionError(f"comm bytes {res['comm_bytes']} != the byte model's "
                             f"{res['outer_syncs']} × {cost.payload_bytes}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"int8 training did not go down: {losses}")
    steps = [e for e in map(json.loads, open(jsonl)) if e["event"] == "step"]
    inner = sorted(e["dt_s"] * 1e3 for e in steps[1:] if e["step"] % TRAIN["inner_steps"])
    outer = time_outer(cfg, res["state"], dev)
    summary = {
        "inner_step_p50_ms": statistics.median(inner), "inner_step_samples": len(inner),
        "outer_step_ms_int8": statistics.median(outer["int8"]),
        "outer_step_ms_none": statistics.median(outer["none"]),
        "outer_step_samples_ms": outer,
        "outer_step_ms_none_phase6": none_summary["outer_step_ms"],
        "comm_bytes": res["comm_bytes"], "comm_bytes_none_phase6": none_summary["comm_bytes"],
        "payload_bytes_per_sync": cost.payload_bytes, "peak_memory_gb": peak_gb,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_last_none_phase6": none_summary["loss_last"],
        "final_weight_std": res["final_weight_std"], "wall_s": res["wall_s"],
    }
    log("train int8 summary: " + json.dumps(summary))
    del res
    torch.cuda.empty_cache()
    return summary, launches


# ---------------------------------------------------------------------------
# Phases 11–12: checkpoint/resume and promotion on the card
# ---------------------------------------------------------------------------

CKPT_RUN = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=64, inner_steps=4,
                eval_every=0, inner_lr=3e-3, seed=0, total_steps=12, codec="int8")


def ckpt_phase(dev) -> dict:
    """6 steps saving every 3 (mid inner phase: syncs fall at 4, 8, 12),
    resumed to 12, against 12 uninterrupted steps, all on the card."""
    cfg = paper_llama.SMALL.reduced(dtype="float32", remat=False)
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    full = train_cli.run_training(cfg, device="cuda", steps=12, **CKPT_RUN)
    train_cli.run_training(cfg, device="cuda", steps=6, ckpt_dir=d, ckpt_every=3, **CKPT_RUN)
    cont = train_cli.run_training(cfg, device="cuda", steps=12, ckpt_dir=d, resume=True, **CKPT_RUN)
    torch.cuda.synchronize()
    trees = ("theta", "phi", "delta")
    pick = lambda st: (st.theta, st.outer.phi, st.outer.delta)
    same = {name: all(torch.equal(a, b) for a, b in zip(tree_leaves(x), tree_leaves(y)))
            for name, x, y in zip(trees, pick(cont["state"]), pick(full["state"]))}
    # the save and the restore of this state (4 replicas of θ, μ, ν, φ, δ)
    program = adapters.GossipProgram(cfg, train_cli.method_config(
        "noloco", inner_lr=3e-3, total_steps=12, inner_steps=4), replicas=4, device=dev)
    tdir = os.path.join(d, "timing")
    save_s, restore_s = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt_lib.save(tdir, i, {"program": program.state_pytree(cont["state"])})
        save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        program.load_state_pytree(cont["state"], ckpt_lib.restore(tdir, i)["program"])
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
    nbytes = os.path.getsize(os.path.join(path, "arrays.msgpack"))
    out = {"start_step": cont["start_step"], "losses_identical": cont["losses"] == full["losses"][6:],
           "bit_identical": same, "losses": cont["losses"], "checkpoints": sorted(os.listdir(d)),
           "state_bytes": nbytes, "save_s": statistics.median(save_s),
           "restore_s": statistics.median(restore_s), "save_samples_s": save_s,
           "restore_samples_s": restore_s, "dir": d}
    log("ckpt resume on card: " + json.dumps(out))
    if cont["start_step"] != 6 or not out["losses_identical"] or not all(same.values()):
        raise AssertionError("the resumed run differs from the uninterrupted one on the card")
    return out


def promote_serve_phase(dev, ckpt_dir: str) -> dict:
    """``repro_torch.launch.serve --ckpt`` on the card and on the CPU."""
    args = ["--arch", "paper-small-125m", "--ckpt", ckpt_dir, "--replica", "1", "--weights",
            "phi", "--requests", "4", "--max-batch", "4", "--prompt-lens", "24,80",
            "--gen-lens", "16,12"]
    logs = {d: os.path.join(ckpt_dir, f"serve_{d}.jsonl") for d in ("cuda", "cpu")}
    dispatch.reset_launches()
    card = serve_cli.main([*args, "--device", "cuda", "--log-jsonl", logs["cuda"]])
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    cpu = serve_cli.main([*args, "--device", "cpu", "--log-jsonl", logs["cpu"]])
    tokens = {d: {e["rid"]: e["tokens"] for e in map(json.loads, open(p)) if e["event"] == "finish"}
              for d, p in logs.items()}
    out = {"promoted": card["promoted"], "tokens_identical": tokens["cuda"] == tokens["cpu"],
           "tokens": tokens["cuda"], "launches": {k: launches[k] for k in PAGED},
           "tokens_per_s": card["tokens_per_s"], "cpu_promoted": cpu["promoted"]}
    log("promote -> serve card vs cpu: " + json.dumps(out))
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"promoted serving skipped a paged kernel: {launches}")
    if len(tokens["cuda"]) != 4 or not out["tokens_identical"]:
        raise AssertionError("promoted serving: card and CPU tokens differ")
    return out


# ---------------------------------------------------------------------------
# Phases 13–15: the recurrent families
# ---------------------------------------------------------------------------


def ssd_chunk_inputs(gen, b, nc, q, h, p, n, pad=0):
    """x, dt (softplus, exactly 0 on the last ``pad`` rows of the last chunk),
    a in [−16, −1], B, C, fp32: the distributions of mamba2's layers."""
    dev = gen.device
    x = torch.randn((b, nc, q, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=gen, device=dev) - 2.0)
    if pad:
        dt[:, -1, q - pad:] = 0.0
    a = -torch.exp(torch.rand((h,), generator=gen, device=dev) * math.log(16.0))
    bm = torch.randn((b, nc, q, n), generator=gen, device=dev)
    cm = torch.randn((b, nc, q, n), generator=gen, device=dev)
    return [x, dt, a, bm, cm]


def rglru_inputs(gen, *shape):
    dev = gen.device
    a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)) * 0.5 + 0.45
    return [a, torch.randn(shape, generator=gen, device=dev)]


def ssd_decode_inputs(gen, r, hp, n):
    dev = gen.device
    state = torch.randn((r, hp, n), generator=gen, device=dev)
    decay = torch.exp(-torch.rand((r, hp), generator=gen, device=dev))
    dtx = torch.randn((r, hp), generator=gen, device=dev)
    b, c = (torch.randn((r, n), generator=gen, device=dev) for _ in range(2))
    return [state, decay, dtx, b, c]


def long_context_inputs(gen, *, chunk, dtype, positions, h=16, kv=1, d=256):
    """recurrentgemma-9b's local layers: MQA, 16 heads of 256, each slot's
    pages in a random order and contexts past the 2,048-token window."""
    dev = gen.device
    c = C if chunk else 1
    need = [(p + c - 1) // BS + 1 for p in positions]
    pages = sum(need) + 3
    perm = torch.randperm(pages, generator=gen, device=dev).to(torch.int32)
    tables = torch.full((len(positions), max(need) + 2), pages, dtype=torch.int32, device=dev)
    start = 0
    for i, n_i in enumerate(need):
        tables[i, :n_i] = perm[start:start + n_i]
        start += n_i
    qshape = (len(positions), c, h, d) if chunk else (len(positions), h, d)
    q = torch.randn(qshape, generator=gen, device=dev).to(dtype)
    kp = torch.randn((pages + 1, BS, kv, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((pages + 1, BS, kv, d), generator=gen, device=dev).to(dtype)
    return [q, kp, vp, tables, torch.tensor(positions, dtype=torch.int32, device=dev)]


def check_recurrent_kernels(dev) -> dict[str, float]:
    """The four recurrent kernels against their plain versions (the decode
    states and the RG-LRU scan bit for bit), each slot's decode row equal to
    its solo run, and the paged kernels at recurrentgemma-9b's shape."""
    gen = torch.Generator(device=dev).manual_seed(7)
    reg = dispatch.registry()
    errors = {name: 0.0 for name in (*RECURRENT, *PAGED)}
    # SSD chunk: the serve shape, Q 16 (reduced), 64 and 128 (training), ragged
    for case, pad in (((1, 1, 32, 32, 64, 128), 0), ((1, 1, 32, 32, 64, 128), 7),
                      ((2, 3, 16, 8, 64, 32), 5), ((2, 2, 64, 4, 64, 128), 0),
                      ((2, 2, 128, 4, 64, 128), 37), ((1, 3, 50, 3, 33, 17), 11)):
        args = ssd_chunk_inputs(gen, *case, pad=pad)
        got = reg["ssd_chunk"].kernel(*args)
        torch.cuda.synchronize()
        want = reg["ssd_chunk"].plain(*args)
        res = [_close(g, w, SSD_ATOL, SSD_RTOL, n) for g, w, n in zip(got, want, ("y", "states"))]
        err = max(e for e, _ in res)
        errors["ssd_chunk"] = max(errors["ssd_chunk"], err)
        if pad:   # pad rows add exact zeros, whatever their x, B and C
            noisy = [t.clone() for t in args]
            for i in (0, 3, 4):
                noisy[i][:, -1, case[2] - pad:] = 1e3 * torch.randn_like(noisy[i][:, -1, case[2] - pad:])
            y2, st2 = reg["ssd_chunk"].kernel(*noisy)
            q_ok = case[2] - pad
            if not (torch.equal(st2, got[1]) and torch.equal(y2[:, -1, :q_ok], got[0][:, -1, :q_ok])):
                raise AssertionError(f"ssd_chunk {case}: dt = 0 pad rows changed the result")
        log(f"check ssd_chunk B,NC,Q,H,P,N={case} pad {pad}: max_abs_err {err:.3e} "
            f"(atol {SSD_ATOL:g}, rtol {SSD_RTOL:g}) {'ok' if all(o for _, o in res) else 'FAIL'}")
        if not all(o for _, o in res):
            raise AssertionError("ssd_chunk disagrees with its plain version")
    for shape in ((1, 32, 4096), (2, 37, 130), (3, 5, 33), (16, 300, 1000)):
        args = rglru_inputs(gen, *shape)
        got = reg["rglru_scan"].kernel(*args)
        torch.cuda.synchronize()
        want = reg["rglru_scan"].plain(*args)
        err = (got - want).abs().max().item()
        errors["rglru_scan"] = max(errors["rglru_scan"], err)
        log(f"check rglru_scan {shape}: max_abs_err {err:.3e} (bit-identical: {torch.equal(got, want)})")
        if not torch.equal(got, want):
            raise AssertionError("rglru_scan differs from its sequential plain version")
    for r, w in ((4, 4096), (3, 130), (1, 7), (5, 257)):
        h, a, b = (torch.randn((r, w), generator=gen, device=dev) for _ in range(3))
        got = reg["rglru_decode"].kernel(h, a, b)
        solo = reg["rglru_decode"].kernel(h[-1:].contiguous(), a[-1:].contiguous(), b[-1:].contiguous())
        torch.cuda.synchronize()
        want = reg["rglru_decode"].plain(h, a, b)
        err = (got - want).abs().max().item()
        errors["rglru_decode"] = max(errors["rglru_decode"], err)
        log(f"check rglru_decode ({r}, {w}): max_abs_err {err:.3e} (bit-identical)")
        if not (torch.equal(got, want) and torch.equal(solo[0], got[-1])):
            raise AssertionError("rglru_decode differs from its plain version or its solo row")
    for r, hp, n in ((4, 2048, 128), (3, 70, 16), (1, 5, 33), (2, 64, 300)):
        args = ssd_decode_inputs(gen, r, hp, n)
        st, y = reg["ssd_decode"].kernel(*args)
        solo = reg["ssd_decode"].kernel(*(t[-1:].contiguous() for t in args))
        torch.cuda.synchronize()
        wst, wy = reg["ssd_decode"].plain(*args)
        # y: an N-term sum in another order, within 1e-5 of Σ|state′·c|
        tol = 1e-5 * torch.einsum("rkn,rn->rk", wst.abs(), args[4].abs())
        err = max((st - wst).abs().max().item(), (y - wy).abs().max().item())
        errors["ssd_decode"] = max(errors["ssd_decode"], err)
        ok = (torch.equal(st, wst) and bool(((y - wy).abs() <= tol).all())
              and torch.equal(solo[0][0], st[-1]) and torch.equal(solo[1][0], y[-1]))
        log(f"check ssd_decode ({r}, {hp}, {n}): state bit-identical, y max_abs_err "
            f"{(y - wy).abs().max().item():.3e} (within 1e-5·Σ|state′·c|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("ssd_decode disagrees with its plain version or its solo row")
    for name in PAGED:
        op = reg[name]
        chunk = name == "paged_chunk_attention"
        for dtype in (torch.bfloat16, torch.float32):
            for mode, window in (("local", 2048), ("causal", 0)):
                args = long_context_inputs(gen, chunk=chunk, dtype=dtype, positions=[3000, 2100, 700])
                got = op.kernel(*args, mode=mode, window=window)
                torch.cuda.synchronize()
                want = op.plain(*args, mode=mode, window=window)
                err, ok = _close(got, want, ATOL[dtype], 0, name)
                errors[name] = max(errors[name], err)
                log(f"check {name} {str(dtype)[6:]} {mode} H16/KV1 D256 window {window} "
                    f"positions [3000, 2100, 700]: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain version at D 256")
    return errors


def ssd_chunk_work(b, nc, q, h, p, n):
    """(bytes, fp32 operations) of the SSD chunk function: x, dt, a, B, C
    read once, y and the states written once; C Bᵀ once per chunk (ngroups
    1) and, per head, the causal y product and the state product, two
    operations per multiply-add."""
    elems = 2 * b * nc * q * h * p + b * nc * q * h + h + 2 * b * nc * q * n + b * nc * h * n * p
    pairs = q * (q + 1) // 2
    ops_ = 2 * b * nc * (pairs * n + h * (pairs * p + q * n * p))
    return 4 * elems, ops_


def _timing(op, args, nbytes, flops, shape, reps=100, plain_reps=20, library=None):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    ms, mhz = cuda_ms(lambda: op.kernel(*args), reps=reps)
    return {"ms": ms, "plain_ms": cuda_ms(lambda: op.plain(*args), reps=plain_reps)[0],
            "library_ms": None if library is None else cuda_ms(library, reps=reps)[0],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "sm_clock_mhz": mhz, "shape": shape}


def time_recurrent_kernels(dev) -> tuple[dict[str, dict], dict[str, dict]]:
    """Kernel, plain and library times of the four kernels at the serve
    shapes (mamba2-370m: one chunk of 32, 32 heads of 64, N 128, 4 decode
    slots; recurrentgemma-9b: width 4096), and of the two scans at the
    training slice's shapes; then the paged kernels at recurrentgemma-9b's
    local layers.  Returns (serve-shape times, the other times)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    reg = dispatch.registry()
    out, extra = {}, {}
    for key, case, reps, plain_reps in (("ssd_chunk", (1, 1, 32, 32, 64, 128), 100, 20),
                                        ("ssd_chunk_train", (16, 8, 128, 32, 64, 128), 20, 3)):
        args = ssd_chunk_inputs(gen, *case)
        nbytes, flops = ssd_chunk_work(*case)
        t = _timing(reg["ssd_chunk"], args, nbytes, flops,
                    {"B,NC,Q,H,P,N": list(case), "dtype": "float32"}, reps, plain_reps)
        (out if key == "ssd_chunk" else extra)[key] = t
        log(f"time {key}: " + json.dumps(t))
        del args
    for key, shape, reps, plain_reps in (("rglru_scan", (1, 32, 4096), 100, 20),
                                         ("rglru_scan_train", (16, 1024, 4096), 20, 3)):
        args = rglru_inputs(gen, *shape)
        n = math.prod(shape)
        t = _timing(reg["rglru_scan"], args, 12 * n, 2 * n,
                    {"B,S,W": list(shape), "dtype": "float32"}, reps, plain_reps)
        (out if key == "rglru_scan" else extra)[key] = t
        log(f"time {key}: " + json.dumps(t))
        del args
    h, a, b = (torch.randn((4, 4096), generator=gen, device=dev) for _ in range(3))
    out["rglru_decode"] = _timing(reg["rglru_decode"], (h, a, b), 16 * h.numel(), 2 * h.numel(),
                                  {"R,W": [4, 4096], "dtype": "float32"},
                                  library=lambda: torch.addcmul(b, a, h))
    log("time rglru_decode: " + json.dumps(out["rglru_decode"]))
    args = ssd_decode_inputs(gen, 4, 2048, 128)
    r, hp, n = args[0].shape
    out["ssd_decode"] = _timing(reg["ssd_decode"], args, 4 * (2 * r * hp * n + 3 * r * hp + 2 * r * n),
                                5 * r * hp * n, {"R,HP,N": [r, hp, n], "dtype": "float32"})
    log("time ssd_decode: " + json.dumps(out["ssd_decode"]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in PAGED:
        op = reg[name]
        chunk = name == "paged_chunk_attention"
        pos = [168] if chunk else DECODE_POS
        args = long_context_inputs(gen, chunk=chunk, dtype=torch.bfloat16, positions=pos)
        q, kp, _, tables, positions = args
        c = q.shape[1] if chunk else 1
        t = int(positions.max()) + c
        blocks = -(-t // BS)
        k = kp[tables[:, :blocks].long()].reshape(len(pos), blocks * BS, 1, 256)[:, :t]
        kd = k.expand(-1, -1, 16, -1).transpose(1, 2).contiguous()
        qd = (q if chunk else q[:, None]).transpose(1, 2).contiguous()
        q_pos = positions[:, None].long() + torch.arange(c, device=dev)[None]
        kpos = torch.arange(t, device=dev)[None, None]
        mask = ((kpos <= q_pos[:, :, None]) & (kpos > q_pos[:, :, None] - 2048))[:, None]
        bound_ms, bound_by = bound(q, kp, positions, chunk, kv=1, d=256)
        ms, mhz = cuda_ms(lambda: op.kernel(*args, mode="local", window=2048))
        extra[f"{name}_recurrentgemma"] = {
            "ms": ms, "plain_ms": cuda_ms(lambda: op.plain(*args, mode="local", window=2048))[0],
            "library_ms": cuda_ms(lambda: sdpa(qd, kd, kd, attn_mask=mask))[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "sm_clock_mhz": mhz,
            "shape": {"q": list(q.shape), "pages": list(kp.shape), "positions": pos,
                      "window": 2048, "dtype": "bfloat16"}}
        log(f"time {name} at recurrentgemma-9b's shape: " + json.dumps(extra[f"{name}_recurrentgemma"]))
    torch.cuda.empty_cache()
    return out, extra


def mamba2_launches(cfg):
    n = cfg.num_layers
    return lambda chunks, steps: {"ssd_chunk": chunks * n, "ssd_decode": steps * n,
                                  "rglru_scan": 0, "rglru_decode": 0,
                                  "paged_attention": 0, "paged_chunk_attention": 0}


def recurrentgemma_launches(cfg):
    kinds = cfg.layer_types
    n_lru, n_attn = kinds.count("rglru"), kinds.count("local")
    return lambda chunks, steps: {"rglru_scan": chunks * n_lru, "rglru_decode": steps * n_lru,
                                  "paged_chunk_attention": chunks * n_attn,
                                  "paged_attention": steps * n_attn,
                                  "ssd_chunk": 0, "ssd_decode": 0}


def recurrent_parity_phase(dev) -> dict:
    """Both families' reduced() configs in fp32: a prompt of 80 and one of
    200 tokens (past the window of 64), 8 greedy decode steps each, on the
    card and on the CPU from the same weights."""
    out = {}
    for base, kernels in ((mamba2_370m.CONFIG, ("ssd_chunk", "ssd_decode")),
                          (recurrentgemma_9b.CONFIG, ("rglru_scan", "rglru_decode") + PAGED)):
        cfg = base.reduced(dtype="float32", remat=False)
        cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
        gpu_params = _tree_to(cpu_params, dev)
        rng = np.random.default_rng(4)
        rows = []
        for length in (80, 200):
            prompt = rng.integers(0, cfg.vocab_size, size=length).tolist()
            dispatch.reset_launches()
            gpu_tokens, gpu_logits = greedy(gpu_params, cfg, prompt, 8, dev)
            launches = dispatch.launch_counts()
            cpu_tokens, cpu_logits = greedy(cpu_params, cfg, prompt, 8, torch.device("cpu"))
            err = (gpu_logits - cpu_logits).abs().max().item()
            rows.append({"prompt": length, "tokens_identical": gpu_tokens == cpu_tokens,
                         "max_logit_diff": err,
                         "launches": {k: launches[k] for k in kernels}})
            log(f"recurrent fp32 card vs cpu {cfg.name} reduced, prompt {length}: card {gpu_tokens}, "
                f"cpu {cpu_tokens}, max logit diff {err:.3e} (atol {LOGIT_ATOL:g}), "
                f"launches {rows[-1]['launches']}")
            if min(rows[-1]["launches"].values()) <= 0:
                raise AssertionError(f"fp32 card run of {cfg.name} skipped a kernel: {launches}")
            if gpu_tokens != cpu_tokens:
                raise AssertionError(f"{cfg.name}: card and CPU greedy tokens differ")
            if not (torch.isfinite(gpu_logits).all() and err <= LOGIT_ATOL):
                raise AssertionError(f"{cfg.name}: card and CPU logits differ beyond tolerance")
        out[base.name] = rows
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

    errors = {**check_kernels(dev), **check_train_kernels(dev), **check_int8_kernels(dev)}
    for name, err in check_recurrent_kernels(dev).items():
        errors[name] = max(errors.get(name, 0.0), err)
    rec_timings, rec_extra = time_recurrent_kernels(dev)
    timings = {**time_kernels(dev), **time_train_kernels(dev), **time_int8_kernels(dev),
               **rec_timings}
    summary, launches = serve_phase(dev)
    slice_err = slice_phase(dev)
    train_summary, train_launches = train_phase(dev)
    parity = train_parity_phase(dev)
    int8_summary, int8_launches = int8_train_phase(dev, train_summary)
    int8_parity = train_parity_phase(dev, codec="int8")
    resume = ckpt_phase(dev)
    promoted = promote_serve_phase(dev, resume["dir"])
    family = {}
    for cfg, expected in ((mamba2_370m.CONFIG, mamba2_launches(mamba2_370m.CONFIG)),
                          (recurrentgemma_9b.CONFIG, recurrentgemma_launches(recurrentgemma_9b.CONFIG))):
        family[cfg.name] = serve_phase(dev, cfg, expected)
    rec_parity = recurrent_parity_phase(dev)
    launches.update({k: train_launches[k] for k in TRAIN_KERNELS})
    launches.update({k: int8_launches[k] for k in INT8})
    launches.update({k: family["mamba2-370m"][1][k] for k in ("ssd_chunk", "ssd_decode")})
    launches.update({k: family["recurrentgemma-9b"][1][k] for k in ("rglru_scan", "rglru_decode")})

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
        "train_int8": int8_summary,
        "train_int8_card_vs_cpu": {k: int8_parity[k] for k in (
            "loss_max_rel_diff", "weight_std_rel_diff", "partner_tables_identical")},
        "ckpt_resume": {k: resume[k] for k in (
            "start_step", "losses_identical", "bit_identical", "state_bytes", "save_s",
            "restore_s")},
        "promote_serve": {k: promoted[k] for k in ("promoted", "tokens_identical")},
        "serve_recurrent": {name: {k: fam[0].get(k) for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "step_p50_s", "step_p99_s",
            "decode_steps", "wall_s", "peak_memory_gb")} for name, fam in family.items()},
        "recurrent_card_vs_cpu": rec_parity,
        "recurrent_timings_other_shapes": {k: {f: v[f] for f in ("ms", "plain_ms", "library_ms",
                                                                 "bound_ms", "bound_by")}
                                           for k, v in rec_extra.items()},
        "seconds": time.perf_counter() - t0}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
