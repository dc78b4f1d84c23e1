"""Continuous-batching inference engine over the paged KV cache.

The port of ``repro/serve/engine.py``.  Scheduler state machine:

    QUEUED ──admit──► PREFILL ──chunks──► DECODING ──evict──► FINISHED
                 ▲    (interleaved         │
                 │     with decode)        │
                 └──────── pages freed ◄───┘

Each :meth:`ServeEngine.step`:
  1. EVICT — slots whose request hit its token budget are read out (the one
     host sync a request costs) and their pages go back to the allocator.
  2. ADMIT — while a slot and enough pages are free, the next queued request
     claims the slot and reserves pages for prompt + max_new under a lease,
     so a running request never runs out of pages mid-decode.
     ``policy="static"`` admits only into an all-idle engine (the baseline).
  3. PREFILL — admitted prompts advance ``prefill_chunk`` tokens per call
     (ragged last chunk masked by position), at most ``prefill_budget``
     tokens per tick, so long prompts interleave with decode.  With
     ``prefill_chunk=0`` a prompt is prefilled whole at admission instead
     (single-shot: batch 1, the flash op over the prompt's fresh K/V, which
     are then scattered into the slot's pages; :func:`repro_torch.models.
     model.paged_prefill`), the JAX engine's baseline.
  4. DECODE — one batched step (:func:`_decode_core`) advances every active
     slot; sampled tokens land in a device-side output buffer.
     :class:`repro_torch.serve.spec.SpecServeEngine` runs the same step
     for its draft on the draft's caches.

The engine state lives on the device and is updated in place.  Recurrent
layers (RG-LRU, SSD) keep one state row per slot in the caches, which every
decode step advances, idle and prefilling rows included.  So a prompt's
chunks run on batch-1 scratch states of their own, made zero at admission
and carried from chunk to chunk; only the last chunk writes them into the
slot's rows, as the JAX engine does.  Sampling is
Gumbel-max with noise keyed by (request id, token index), never by engine
step, so a request decoded in a churning batch gives the tokens of a solo
run, greedy or sampled.  The noise is the JAX engine's: token i of request
rid draws ``jax.random.gumbel(fold_in(fold_in(PRNGKey(17), rid), i), (V,))``,
its keys derived on the host (:mod:`repro_torch.core.pairing`) and its
threefry bits drawn on the logits' device, every sampled row of a step in
one batch; the uniforms are bit-identical to JAX's and the logs are
torch's.

MoE blocks break the batched == solo guarantee, as in the JAX engine:
capacity is shared by the rows routed together (a prefill chunk with its
pad rows, a decode step's R rows with the idle slots'), so a request's
tokens can depend on what else is in the batch.  They serve fine, and give
the JAX engine's tokens for the same load.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import pairing
from repro_torch.models import model as M
from repro_torch.models.attention import PagedAttnCache, PagedView
from repro_torch.models.config import ModelConfig
from repro_torch.serve.paged import BlockAllocator

__all__ = ["Request", "FinishedRequest", "ServeConfig", "EngineState", "ServeEngine"]

_SAMPLE_KEY = pairing.prng_key(17)  # root of every sampling stream
_TINY = torch.finfo(torch.float32).tiny


def _sample_key(rid: int, index: int) -> np.ndarray:
    """Key of token ``index`` of request ``rid``: fold_in(fold_in(root, rid), index)."""
    return pairing.fold_in(pairing.fold_in(_SAMPLE_KEY, rid), index)


def _uniform(keys: np.ndarray, vocab: int, device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(key, (vocab,), float32, minval=tiny, maxval=1)``
    of each row of ``keys`` (n, 2), as (n, vocab): the top 23 bits of each
    word under the exponent of 1.0, minus 1, moved into [tiny, 1)."""
    bits = pairing.random_bits_torch(torch.from_numpy(keys.astype(np.int64)), vocab, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    one = torch.tensor(1.0, dtype=torch.float32)
    return torch.clamp_min(f * (one - _TINY) + _TINY, _TINY)


def _gumbel(keys: np.ndarray, vocab: int, device: torch.device) -> torch.Tensor:
    """``jax.random.gumbel(key, (vocab,), float32)`` of each row of ``keys``:
    −log(−log u)."""
    return -torch.log(-torch.log(_uniform(keys, vocab, device)))


def _perturb(logits: torch.Tensor, draws: list[tuple[float, int, int] | None]) -> torch.Tensor:
    """``logits + t·gumbel`` for every row r with ``draws[r]`` = (temperature
    t > 0, rid, token index); other rows as they are.  The noisy rows draw
    their noise in one (n, V) batch."""
    noisy = [i for i, d in enumerate(draws) if d is not None and d[0] > 0]
    if not noisy:
        return logits
    keys = np.stack([_sample_key(draws[i][1], draws[i][2]) for i in noisy])
    g = _gumbel(keys, logits.shape[-1], logits.device)
    temps = torch.tensor([draws[i][0] for i in noisy], dtype=torch.float32)
    rows = torch.tensor(noisy, device=logits.device)
    logits = logits.clone()
    logits[rows] = logits[rows] + temps.to(logits.device)[:, None] * g
    return logits


def _sample(logits: torch.Tensor, draws: list[tuple[float, int, int] | None]) -> torch.Tensor:
    """Temperature-t categorical as argmax(logits + t·gumbel), t = 0 greedy.
    ``draws[r]`` is (temperature, rid, token index) of row r, or None for a
    row whose token is discarded.  Returns (R,) int32."""
    return torch.argmax(_perturb(logits, draws), dim=-1).to(torch.int32)


def _recurrent(entry) -> bool:
    """Whether a cache-tree entry holds per-slot recurrent states."""
    return entry is not None and not isinstance(entry[0], PagedAttnCache)


def _tensors(cache) -> dict[str, torch.Tensor]:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    temperature: float = 0.0
    submit_t: float = 0.0


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    prompt: list[int]
    tokens: list[int]
    submit_t: float
    admit_t: float       # prefill completed = first token exists
    finish_t: float
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def ttft_s(self) -> float:
        return self.admit_t - self.submit_t


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_slots: int = 4          # R: concurrent requests in the decode batch
    num_pages: int = 128        # KV page pool size (per layer), excl. trash
    page_size: int = 16         # tokens per page
    max_new_cap: int = 128      # on-device output buffer width
    policy: str = "continuous"  # "continuous" | "static" (baseline)
    sync_each_step: bool = False  # block per decode step (per-token timing)
    prefill_chunk: int = 32     # chunked-prefill width; 0 = single-shot
    prefill_budget: int = 0     # max prefill tokens per tick; 0 = unlimited

    def validate(self) -> None:
        if self.policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.max_slots < 1:
            raise ValueError("need at least one slot")
        if self.prefill_chunk < 0 or self.prefill_budget < 0:
            raise ValueError("prefill_chunk/prefill_budget must be >= 0")
        if self.prefill_budget and not self.prefill_chunk:
            raise ValueError("prefill_budget requires chunked prefill")


@dataclasses.dataclass
class EngineState:
    """Everything the decode step touches, on the device, updated in place."""

    caches: Any                 # paged attention pools + per-slot recurrent states
    block_tables: torch.Tensor  # (R, MB) int32
    tokens: torch.Tensor        # (R,) int32 — token being fed this step
    positions: torch.Tensor     # (R,) int32 — its position
    active: torch.Tensor        # (R,) bool
    out_buf: torch.Tensor | None  # (R, CAP) int32 — generated tokens (None: not kept)
    out_len: torch.Tensor       # (R,) int32


def _zero_scratch(caches: dict) -> dict:
    """Batch-1 zero copies of the recurrent cache entries of ``caches``
    (None for page pools): the state a prompt starts from."""
    def zero(entry, ax):
        if not _recurrent(entry):
            return None
        cache = entry[0]
        return (type(cache)(**{
            k: torch.zeros(t.shape[:ax] + (1,) + t.shape[ax + 1:], dtype=t.dtype, device=t.device)
            for k, t in _tensors(cache).items()}), None)

    return {"scan": [zero(e, 1) for e in caches["scan"]],
            "rem": [zero(e, 0) for e in caches["rem"]]}


def _prefill_caches(caches: dict, scratch: dict) -> dict:
    """The caches a prefill runs on: the page pools of ``caches`` and the
    slot's batch-1 recurrent scratch, which the prefill advances in place."""
    return {part: [s if s is not None else e for e, s in zip(caches[part], scratch[part])]
            for part in ("scan", "rem")}


def _commit_scratch(caches: dict, scratch: dict, slot: int) -> None:
    """Write a prompt's final recurrent states into the slot's rows."""
    for part, stacked in (("scan", True), ("rem", False)):
        for entry, one in zip(caches[part], scratch[part]):
            if one is None:
                continue
            full = _tensors(entry[0])
            for k, t in _tensors(one[0]).items():
                if stacked:
                    full[k][:, slot] = t[:, 0]
                else:
                    full[k][slot] = t[0]


def _decode_core(params: Any, cfg: ModelConfig, st: EngineState,
                 draws: list[tuple[float, int, int] | None]) -> torch.Tensor:
    """One batched decode step over every slot of ``st``, in place: the
    caches advance, each active slot's sampled token becomes its next
    input and (when ``st.out_buf`` is kept) lands at index ``out_len``,
    and active positions and lengths move by one.  ``draws[r]`` keys row
    r's noise, (temperature, rid, token index), as :func:`_sample`.  The
    speculative engine runs its draft through this same step, on the
    draft's caches and on copies of tokens, positions and lengths.
    Returns the sampled tokens (R,) int32."""
    view = PagedView(st.block_tables, st.positions, st.active)
    logits, _ = M.paged_decode_step(params, cfg, st.tokens[:, None], st.caches, view)
    nxt = _sample(logits[:, 0], draws)
    if st.out_buf is not None:
        row = torch.arange(st.out_buf.shape[0], device=nxt.device)
        idx = st.out_len.long().clamp(0, st.out_buf.shape[1] - 1)
        st.out_buf[row, idx] = torch.where(st.active, nxt, st.out_buf[row, idx])
    st.tokens.copy_(torch.where(st.active, nxt, st.tokens))
    act = st.active.to(torch.int32)
    st.positions += act
    st.out_len += act
    return nxt


class ServeEngine:
    """Request-driven serving engine for one decoder-only model, on the
    device its parameters live on."""

    def __init__(self, params: Any, cfg: ModelConfig, scfg: ServeConfig):
        scfg.validate()
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.device = params["embed"]["table"].device
        self.alloc = BlockAllocator(scfg.num_pages, scfg.page_size)
        r, mb = scfg.max_slots, scfg.num_pages
        self._mb = mb
        dev = self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = EngineState(
            caches=M.init_paged_cache_tree(cfg, r, scfg.num_pages, scfg.page_size, dev),
            block_tables=torch.full((r, mb), self.alloc.trash_page, dtype=torch.int32, device=dev),
            tokens=zeros(r),
            positions=zeros(r),
            active=zeros(r, dtype=torch.bool),
            out_buf=zeros(r, scfg.max_new_cap),
            out_len=zeros(r),
        )
        self.queue: list[Request] = []
        # host mirror of per-slot occupancy: request, lease/blocks, phase
        # ("prefill" | "decode"), prefill cursor, admit_t, steps, per-token
        # dispatch times, streamed-token watermark
        self._slots: list[dict | None] = [None] * r
        self._token_cb = None
        self.decode_steps = 0
        self.decode_step_times: list[float] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- scheduler ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.max_new > self.scfg.max_new_cap:
            raise ValueError(
                f"request {req.rid}: max_new {req.max_new} exceeds engine cap "
                f"{self.scfg.max_new_cap}"
            )
        need = self.alloc.blocks_for(len(req.prompt) + req.max_new)
        if need > self.alloc.num_pages or need > self._mb:
            raise ValueError(
                f"request {req.rid} needs {need} pages; pool holds "
                f"{self.alloc.num_pages}"
            )
        if not req.submit_t:
            req.submit_t = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _emit_tokens(self, slot: int, occ: dict, out_buf, upto: int) -> None:
        """Stream tokens [emitted, upto) of a slot to the token callback,
        stamped with their decode dispatch times (host times; exact when
        sync_each_step, otherwise early by the device queue depth)."""
        if self._token_cb is None:
            return
        req: Request = occ["req"]
        upto = min(upto, req.max_new)
        for i in range(occ["emitted"], upto):
            t = occ["t_toks"][i] if i < len(occ["t_toks"]) else time.perf_counter()
            self._token_cb(req.rid, i, int(out_buf[slot, i]), t)
        occ["emitted"] = max(occ["emitted"], upto)

    def drain(self) -> None:
        """Flush generated-but-unstreamed tokens to the token callback with
        one device read for the whole batch."""
        if self._token_cb is None:
            return
        pending = [
            (slot, occ) for slot, occ in enumerate(self._slots)
            if occ is not None and occ["phase"] == "decode"
            and occ["emitted"] < min(occ["steps"], occ["req"].max_new)
        ]
        if not pending:
            return
        out_buf = self.state.out_buf.cpu().numpy()
        for slot, occ in pending:
            self._emit_tokens(slot, occ, out_buf, min(occ["steps"], occ["req"].max_new))

    def _evict_finished(self) -> list[FinishedRequest]:
        done: list[FinishedRequest] = []
        out_buf = None
        st = self.state
        for slot, occ in enumerate(self._slots):
            if (
                occ is None or occ["phase"] != "decode"
                or occ["steps"] < occ["req"].max_new
            ):
                continue
            if out_buf is None:  # one device read serves every eviction this step
                out_buf = st.out_buf.cpu().numpy()
            req: Request = occ["req"]
            toks = out_buf[slot, : req.max_new].tolist()
            self._emit_tokens(slot, occ, out_buf, req.max_new)
            done.append(
                FinishedRequest(
                    rid=req.rid, prompt=req.prompt, tokens=toks,
                    submit_t=req.submit_t, admit_t=occ["admit_t"],
                    finish_t=time.perf_counter(),
                    stats=self._finish_stats(occ),
                )
            )
            self.alloc.free(occ["blocks"])
            self._slots[slot] = None
            st.active[slot] = False
            st.positions[slot] = 0
            st.tokens[slot] = 0
            st.out_len[slot] = 0
        return done

    def _admit(self) -> None:
        if self.scfg.policy == "static" and any(s is not None for s in self._slots):
            return  # static baseline: wait for the whole batch to drain
        free = self._free_slots()
        while self.queue and free:
            req = self.queue[0]
            need = self.alloc.blocks_for(len(req.prompt) + req.max_new)
            if not self.alloc.can_alloc(need):
                break  # head-of-line blocks until pages free up (no preempt)
            self.queue.pop(0)
            slot = free.pop(0)
            if not self.scfg.prefill_chunk:
                self._prefill_whole(slot, req, self.alloc.alloc(need))
                continue
            # pages leave the free list under a lease (committed when the
            # last chunk lands); the slot parks in "prefill" phase
            lease = self.alloc.reserve(need)
            row_dev = self._table_row(lease.blocks)
            self.state.block_tables[slot] = row_dev
            self._slots[slot] = {
                "req": req, "lease": lease, "row": row_dev,
                "rec": _zero_scratch(self.state.caches),
                "phase": "prefill", "cursor": 0,
                "admit_t": 0.0, "steps": 0, "t_toks": [], "emitted": 0,
            }

    def _table_row(self, blocks: list[int]) -> torch.Tensor:
        """A slot's block-table row on the device: its pages, then trash."""
        row = np.full((self._mb,), self.alloc.trash_page, np.int32)
        row[: len(blocks)] = blocks
        return torch.from_numpy(row).to(self.device)

    def _start_decode(self, slot: int, req: Request, tok0: torch.Tensor) -> None:
        """Move a prefilled slot into the decode batch with token 0."""
        st = self.state
        st.tokens[slot] = tok0
        st.positions[slot] = len(req.prompt)
        st.active[slot] = True
        st.out_buf[slot, 0] = tok0
        st.out_len[slot] = 1

    def _prefill_whole(self, slot: int, req: Request, blocks: list[int]) -> None:
        """Single-shot admission (``prefill_chunk=0``): the whole prompt in
        one batch-1 call on zero recurrent scratch, its pages owned at once,
        token 0 sampled with key (rid, 0); the slot goes straight into the
        decode batch."""
        dev = self.device
        row_dev = self._table_row(blocks)
        st = self.state
        st.block_tables[slot] = row_dev
        scratch = _zero_scratch(st.caches)
        view = PagedView(row_dev[None], torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.ones((1,), dtype=torch.bool, device=dev))
        toks = torch.tensor([req.prompt], dtype=torch.int32).to(dev)
        logits, _ = M.paged_prefill(self.params, self.cfg, toks,
                                    _prefill_caches(st.caches, scratch), view)
        _commit_scratch(st.caches, scratch, slot)
        self._start_decode(slot, req, _sample(logits[:, 0], [(req.temperature, req.rid, 0)])[0])
        now = time.perf_counter()
        self._slots[slot] = {"req": req, "blocks": blocks, "phase": "decode", "admit_t": now,
                             "steps": 1, "t_toks": [now], "emitted": 0}

    def _chunk_logits(self, params: Any, cfg: ModelConfig, caches: dict, scratch: dict,
                      occ: dict, cur: int, n: int) -> torch.Tensor:
        """One prefill chunk of a slot's prompt, tokens [cur, cur + n), on
        ``caches``' page pools and the slot's batch-1 ``scratch``; returns
        the logits of its last valid position (1, 1, V)."""
        dev = self.device
        c = self.scfg.prefill_chunk
        toks = torch.tensor([occ["req"].prompt[cur: cur + n] + [0] * (c - n)], dtype=torch.int32)
        view = PagedView(
            occ["row"][None],
            torch.tensor([cur], dtype=torch.int32).to(dev),
            torch.ones((1,), dtype=torch.bool, device=dev),
        )
        logits, _ = M.paged_prefill_chunk(
            params, cfg, toks.to(dev), _prefill_caches(caches, scratch), view,
            lengths=torch.tensor([n], dtype=torch.int32).to(dev),
        )
        return logits

    def _prefill_chunk_step(self, slot: int) -> None:
        """Advance one prefill-phase slot by one fixed-width chunk; on the
        last chunk, commit the lease and move the slot into the decode
        batch."""
        occ = self._slots[slot]
        req: Request = occ["req"]
        cur = occ["cursor"]
        n = min(self.scfg.prefill_chunk, len(req.prompt) - cur)
        logits = self._chunk_logits(self.params, self.cfg, self.state.caches, occ["rec"],
                                    occ, cur, n)
        occ["cursor"] = cur + n
        if occ["cursor"] < len(req.prompt):
            return
        _commit_scratch(self.state.caches, occ.pop("rec"), slot)
        occ["blocks"] = self.alloc.commit(occ.pop("lease"))
        self._start_decode(slot, req, _sample(logits[:, 0], [(req.temperature, req.rid, 0)])[0])
        now = time.perf_counter()
        occ.update({"phase": "decode", "admit_t": now, "steps": 1})
        occ["t_toks"].append(now)

    def _advance_prefills(self) -> None:
        """Spend up to ``prefill_budget`` prompt tokens (0 = all pending) on
        chunk steps, round-robin over prefill-phase slots."""
        if not self.scfg.prefill_chunk:
            return
        budget = self.scfg.prefill_budget or (1 << 30)
        while budget > 0:
            pending = [
                s for s, occ in enumerate(self._slots)
                if occ is not None and occ["phase"] == "prefill"
            ]
            if not pending:
                return
            for slot in pending:
                if budget <= 0:
                    return
                self._prefill_chunk_step(slot)
                budget -= self.scfg.prefill_chunk

    def _decode(self) -> None:
        """One batched decode step over every slot, in place."""
        draws = [
            (occ["req"].temperature, occ["req"].rid, occ["steps"])
            if occ is not None and occ["phase"] == "decode" else None
            for occ in self._slots
        ]
        _decode_core(self.params, self.cfg, self.state, draws)

    def _finish_stats(self, occ: dict) -> dict:
        """Per-request stats attached at eviction; the speculative engine
        adds its own."""
        return {}

    def step(self) -> list[FinishedRequest]:
        """One scheduler tick: evict → admit → prefill chunks → batched decode."""
        done = self._evict_finished()
        self._admit()
        self._advance_prefills()
        if any(
            s is not None and s["phase"] == "decode"
            and s["steps"] < s["req"].max_new
            for s in self._slots
        ):
            t0 = time.perf_counter()
            self._decode()
            if self.scfg.sync_each_step:
                self._sync()
            now = time.perf_counter()
            if self.scfg.sync_each_step:
                self.decode_step_times.append(now - t0)
            self.decode_steps += 1
            for occ in self._slots:
                if occ is not None and occ["phase"] == "decode":
                    if occ["steps"] < occ["req"].max_new:
                        occ["t_toks"].append(now)
                    occ["steps"] += 1
        return done

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self._slots)

    def run(
        self,
        requests: list[Request],
        token_cb=None,
        drain_every: int = 0,
    ) -> list[FinishedRequest]:
        """Serve a batch of requests to completion (submit-all load).

        ``token_cb(rid, index, token, dispatch_t)`` streams tokens as they
        reach the host: on each eviction wave and, if ``drain_every`` > 0,
        every that-many ticks via :meth:`drain`."""
        self._token_cb = token_cb
        for r in requests:
            self.submit(r)
        finished: list[FinishedRequest] = []
        guard = 0
        limit = (
            10_000
            + sum(r.max_new for r in requests) * 4
            + sum(len(r.prompt) for r in requests)
        )
        while not self.idle:
            finished.extend(self.step())
            guard += 1
            if drain_every and guard % drain_every == 0:
                self.drain()
            if guard > limit:  # pragma: no cover
                raise RuntimeError("serve loop failed to converge")
        finished.extend(self._evict_finished())
        return finished
