"""Ensemble speculative decoding: a second NoLoCo replica drafts, the
promoted target verifies (the port of ``repro/serve/spec.py``).

NoLoCo's partial averaging (paper Eqs. 2–3) never collapses the ensemble: a
checkpoint holds R slightly different replicas, so a second replica, or a
depth-truncated slice of the first (:func:`repro_torch.serve.promote.
truncate_layers`), is a free draft model that agrees with the target on
most easy tokens.  One round of :class:`SpecServeEngine`:

  * DRAFT — ``spec_k`` decode steps of the draft propose a token run.  Each
    step is :func:`repro_torch.serve.engine._decode_core` on the draft's
    parameters and caches and on copies of the engine's tokens, positions
    and lengths, with the noise of token i of request rid keyed by
    (rid, i), so the proposals are what the draft would decode alone.
  * VERIFY — one :func:`repro_torch.models.model.paged_prefill_chunk` call
    of the target with ``collect=True`` scores the feed ``[token, p_1 …
    p_{k−1}]``.  It runs attention and the recurrent mixers as k decode
    steps, the decode step's own computation, and leaves the target's
    recurrent rows unwritten: it returns their per-token trajectories.  So
    the accepted prefix plus the first corrected token are the tokens the
    target would give alone, greedy or sampled (noise keyed by (rid, i),
    whoever proposed the token).
  * COMMIT / ROLL BACK — per slot, ``commit = min(accepted + 1,
    remaining)`` tokens land in the output buffer and the position moves by
    ``commit``.  Page pools need no roll back: the positional mask hides
    the rejected tokens' K/V and decode overwrites them.  The target's
    recurrent rows take their trajectory at ``commit − 1``; the draft's take
    the snapshot after its step ``commit − 1``, and the copy made before the
    round on slots that committed nothing.

The draft shares the target's block tables and page allocator (the same
page ids index its own pools), so admission and leak accounting stay in one
place.  Each round reads ``commit`` and ``accepted`` to the host once.

Noise is drawn only for rows whose token can matter: a draft step's
proposal that the round can still commit, a verify position below the
slot's remaining budget; the others are greedy.  The committed tokens and
the acceptance counts are those of the JAX engine, which draws noise for
every row.  Caches are updated in place, so the draft's snapshots are
buffers allocated once, (k, …) per recurrent leaf, not views.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from repro_torch.models import model as M
from repro_torch.models.attention import PagedView
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import (
    EngineState,
    ServeConfig,
    ServeEngine,
    _commit_scratch,
    _decode_core,
    _recurrent,
    _sample,
    _tensors,
    _zero_scratch,
)

__all__ = ["SpecServeEngine"]


def _rec_pairs(a: dict, b: dict):
    """(leaf of ``a``, matching leaf of ``b``, slot axis) for every leaf of
    the recurrent entries of two cache trees of one structure: the slot
    axis is 1 on the depth-stacked "scan" entries and 0 on "rem"."""
    for part, ax in (("scan", 1), ("rem", 0)):
        for ea, eb in zip(a[part], b[part]):
            if _recurrent(ea):
                ta, tb = _tensors(ea[0]), _tensors(eb[0])
                for name in ta:
                    yield ta[name], tb[name], ax


def _keep_where(keep: torch.Tensor, new: torch.Tensor, old: torch.Tensor, ax: int) -> torch.Tensor:
    shape = [1] * old.dim()
    shape[ax] = -1
    return torch.where(keep.view(shape), new, old)


class SpecServeEngine(ServeEngine):
    """ServeEngine whose decode step is a speculative round.

    ``spec_k`` is the round width: the draft runs ``spec_k`` decode steps
    and the target verifies ``spec_k`` fed tokens, committing between 1 and
    ``spec_k`` tokens per round (no bonus token, so the draft never has to
    catch up: its snapshots cover every commit).  ``spec_k=1`` is plain
    decode plus wasted draft work.

    The output is exactly the target engine's; the draft moves only the
    speed."""

    def __init__(
        self,
        params: Any,
        cfg: ModelConfig,
        scfg: ServeConfig,
        draft_params: Any,
        draft_cfg: ModelConfig | None = None,
        *,
        spec_k: int = 4,
    ):
        if not scfg.prefill_chunk:
            raise ValueError("speculative decode requires chunked prefill "
                             "(prefill_chunk > 0)")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        dcfg = draft_cfg or cfg
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        super().__init__(params, cfg, scfg)
        self.dcfg = dcfg
        self.draft_params = draft_params
        self.spec_k = spec_k
        r, dev = scfg.max_slots, self.device
        self.draft_caches = M.init_paged_cache_tree(dcfg, r, scfg.num_pages, scfg.page_size, dev)
        # one more output column, where a round's uncommitted tokens go
        self.state.out_buf = torch.zeros((r, scfg.max_new_cap + 1), dtype=torch.int32, device=dev)
        # per recurrent leaf of the draft: the copy made before a round and
        # the state after each of its k steps
        self._draft_rec = [(t, ax) for t, _, ax in _rec_pairs(self.draft_caches,
                                                              self.draft_caches)]
        self._pre = [torch.empty_like(t) for t, _ in self._draft_rec]
        self._snaps = [torch.empty((spec_k,) + t.shape, dtype=t.dtype, device=dev)
                       for t, _ in self._draft_rec]
        self.spec_rounds = 0
        self.spec_commit_total = 0
        self.spec_accept_total = 0
        self.spec_prop_total = 0

    @property
    def accept_rate(self) -> float:
        """Accepted / usable draft proposals.  A slot-round with ``rem``
        budget tokens left can accept at most min(spec_k − 1, rem − 1)
        proposals (commit is capped at rem), so that is what it adds to the
        denominator: a perfect draft scores 1.0 on the budget-tail rounds
        too.  With no usable proposal yet (no round, or rem == 1 in every
        round) the rate is vacuously 1.0: no usable proposal was rejected."""
        if not self.spec_prop_total:
            return 1.0
        return self.spec_accept_total / self.spec_prop_total

    # -- prefill: the draft walks the same chunks through its own caches ----

    def _prefill_chunk_step(self, slot: int) -> None:
        occ = self._slots[slot]
        req = occ["req"]
        cur = occ["cursor"]
        if cur == 0:
            occ["rec_d"] = _zero_scratch(self.draft_caches)
        n = min(self.scfg.prefill_chunk, len(req.prompt) - cur)
        # the draft's logits are not sampled: token 0 is the target's
        self._chunk_logits(self.draft_params, self.dcfg, self.draft_caches, occ["rec_d"],
                           occ, cur, n)
        if cur + n == len(req.prompt):
            _commit_scratch(self.draft_caches, occ.pop("rec_d"), slot)
        super()._prefill_chunk_step(slot)

    # -- decode: one speculative round per tick -----------------------------

    def _round(self) -> tuple[list[int], list[int]]:
        """One speculative round over every slot, in place.  Returns each
        slot's committed and accepted counts (the round's one host read)."""
        st, k, dev = self.state, self.spec_k, self.device
        slots = [occ if occ is not None and occ["phase"] == "decode" else None
                 for occ in self._slots]
        r = len(slots)
        # tokens each decoding slot may still commit this round
        rem = [max(min(o["req"].max_new - o["steps"], k), 0) if o else 0 for o in slots]

        def draws(j: int, limit: int):
            return [(o["req"].temperature, o["req"].rid, o["steps"] + j)
                    if o is not None and j < rem[i] - limit else None
                    for i, o in enumerate(slots)]

        # -- draft: k decode steps on its own caches --------------------------
        for (leaf, _), pre in zip(self._draft_rec, self._pre):
            pre.copy_(leaf)
        dstate = EngineState(
            caches=self.draft_caches, block_tables=st.block_tables, tokens=st.tokens.clone(),
            positions=st.positions.clone(), active=st.active, out_buf=None,
            out_len=st.out_len.clone(),
        )
        props = torch.empty((r, k), dtype=torch.int32, device=dev)
        for j in range(k):
            # proposal j (p_{j+1}) can be committed only while j + 1 < rem
            props[:, j] = _decode_core(self.draft_params, self.dcfg, dstate, draws(j, 1))
            for (leaf, _), snap in zip(self._draft_rec, self._snaps):
                snap[j].copy_(leaf)

        # -- verify: the target scores [token, p_1 … p_{k−1}] in one call -----
        feed = torch.cat([st.tokens[:, None], props[:, : k - 1]], dim=1)
        rem_t = torch.tensor(rem, dtype=torch.int32).to(dev)
        view = PagedView(st.block_tables, st.positions, st.active)
        logits, traj = M.paged_prefill_chunk(self.params, self.cfg, feed, st.caches, view,
                                             lengths=rem_t, collect=True)
        # position j's token can be committed only while j < rem
        by_col = [draws(j, 0) for j in range(k)]
        noise = [by_col[j][i] for i in range(r) for j in range(k)]
        o = _sample(logits.reshape(r * k, -1), noise).view(r, k)

        # -- accept the matching prefix and the first correction --------------
        eq = (props[:, : k - 1] == o[:, : k - 1]).to(torch.int32)
        accepted = torch.cumprod(eq, dim=1).sum(dim=1).to(torch.int32)
        commit = torch.minimum(accepted + 1, rem_t)
        keep = commit > 0
        sel = (commit - 1).clamp(0, k - 1).long()
        cols = torch.arange(k, device=dev)[None, :]
        cap = st.out_buf.shape[1] - 1
        wi = torch.where(cols < commit[:, None], st.out_len.long()[:, None] + cols,
                         torch.full_like(cols, cap))
        rows = torch.arange(r, device=dev)[:, None].expand(r, k)
        st.out_buf[rows, wi] = o
        t_next = o.gather(1, sel[:, None])[:, 0]
        st.tokens.copy_(torch.where(keep, t_next, st.tokens))
        st.positions += commit
        st.out_len += commit

        # -- recurrent rows: the target's trajectory, the draft's snapshots ----
        ar = torch.arange(r, device=dev)
        for old, new, ax in _rec_pairs(st.caches, traj):
            # new: (L?, R, C, ...) with the slot axis at ax and C after it
            picked = new.movedim(ax, 0).movedim(ax + 1, 1)[ar, sel].movedim(0, ax)
            old.copy_(_keep_where(keep, picked, old, ax))
        for (leaf, ax), pre, snap in zip(self._draft_rec, self._pre, self._snaps):
            picked = snap.movedim(ax + 1, 0)[ar, sel].movedim(0, ax)
            leaf.copy_(_keep_where(keep, picked, pre, ax))

        counts = torch.stack([commit, accepted]).cpu()
        return counts[0].tolist(), counts[1].tolist()

    def step(self):
        done = self._evict_finished()
        self._admit()
        self._advance_prefills()
        if any(
            s is not None and s["phase"] == "decode"
            and s["steps"] < s["req"].max_new
            for s in self._slots
        ):
            t0 = time.perf_counter()
            commits, accepts = self._round()
            now = time.perf_counter()
            if self.scfg.sync_each_step:
                self.decode_step_times.append(now - t0)
            self.decode_steps += 1
            self.spec_rounds += 1
            for slot, occ in enumerate(self._slots):
                if occ is None or occ["phase"] != "decode":
                    continue
                n = commits[slot]
                if n <= 0:
                    continue
                rem = occ["req"].max_new - occ["steps"]
                usable = max(min(self.spec_k - 1, rem - 1), 0)
                acc = min(accepts[slot], usable)
                occ["spec_rounds"] = occ.get("spec_rounds", 0) + 1
                occ["spec_commit"] = occ.get("spec_commit", 0) + n
                occ["spec_accept"] = occ.get("spec_accept", 0) + acc
                occ["spec_prop"] = occ.get("spec_prop", 0) + usable
                self.spec_commit_total += n
                self.spec_accept_total += acc
                self.spec_prop_total += usable
                for _ in range(n):
                    if occ["steps"] < occ["req"].max_new:
                        occ["t_toks"].append(now)
                    occ["steps"] += 1
        return done

    def _finish_stats(self, occ: dict) -> dict:
        prop = occ.get("spec_prop", 0)
        acc = occ.get("spec_accept", 0)
        return {
            "spec_rounds": occ.get("spec_rounds", 0),
            "spec_tokens": occ.get("spec_commit", 0),
            # no usable proposal (e.g. max_new == 1) is vacuously perfect,
            # the convention of ``accept_rate``
            "accept_rate": acc / prop if prop else 1.0,
        }
