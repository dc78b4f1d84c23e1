"""The training loop (the port of ``repro/train/loop.py``).

Owns the runtime-agnostic half of training: the step loop with its eval
cadence, wall-clock and tokens/s accounting, comm-bytes accounting from
:mod:`repro_torch.comm.bytes_model` (per outer sync: payload and blocking
bytes), the JSONL telemetry stream with the JAX package's schema
(``run_start`` / ``step`` / ``outer`` / ``eval`` / ``ckpt`` / ``run_end``,
``membership`` / ``outer_async`` for elastic programs, ``stream_sync``
for streaming ones, whose ``outer`` bytes are then the synced streams',
and ``recompile`` for a pool's first use of an entry (the replica group);
one JSON object per line) and the same run summary, and periodic
checkpoints with full resume: the program's state (``TrainProgram.
state_pytree``) and the loop's step cursor, in the JAX package's layout, the
data loader fast-forwarded with ``make_loader(start_step)``.  A resumed run
continues the uninterrupted trajectory exactly.

A program of several ranks (``rank``, ``barrier``: the replica group's
:class:`~repro_torch.train.adapters.DistributedProgram`) runs the loop on
every rank: each builds the checkpoint tree (a gather), rank 0 alone
writes it and the telemetry, and the ranks meet at a barrier after every
save, so none reads a checkpoint that is still being written.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch import checkpoint as ckpt_lib
from repro_torch.train.program import TrainProgram

__all__ = ["LoopConfig", "TrainLoop", "make_loop"]


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Runtime-agnostic knobs of the training loop."""

    steps: int
    eval_every: int = 0         # 0: never evaluate mid-run
    seed: int = 0               # names the run's PRNG keys in the checkpoint
    ckpt_dir: str | None = None
    ckpt_every: int = 0         # 0: only the final save (when ckpt_dir set)
    ckpt_keep: int = 3          # retained checkpoints
    resume: bool = False        # restore from the latest checkpoint under ckpt_dir
    log_jsonl: str | None = None  # telemetry stream path (appended)
    log: bool = False           # human-readable progress prints
    run_name: str = "train"     # tag in telemetry events


class TrainLoop:
    """Drive a :class:`~repro_torch.train.program.TrainProgram` end to end.

    ``make_loader(start_step)`` returns the deterministic stacked-batch
    stream beginning at ``start_step``; ``eval_set`` is a fixed list of
    stacked batches (may be empty)."""

    def __init__(self, program: TrainProgram, make_loader: Callable[[int], Iterator[dict]],
                 cfg: LoopConfig, *, eval_set: list[dict] | None = None):
        self.program = program
        self.make_loader = make_loader
        self.cfg = cfg
        self.eval_set = eval_set or []
        self._jsonl = None
        self._writer = getattr(program, "rank", 0) == 0

    def _emit(self, event: str, **fields) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"event": event, "run": self.cfg.run_name, **fields}) + "\n")
        self._jsonl.flush()

    def _keys(self) -> dict:
        """The loop's PRNG keys as the JAX package's legacy
        ``jax.random.PRNGKey`` holds them (uint32 ``[0, seed]``).  The
        port's steps draw nothing from them; they ride in the checkpoint so
        that the JAX package's ``restore`` finds them."""
        return {"train_key": np.array([0, self.cfg.seed + 1], dtype=np.uint32),
                "eval_key": np.array([0, self.cfg.seed + 777], dtype=np.uint32)}

    def _save(self, step: int, state, keys: dict) -> str:
        t0 = time.time()
        tree = {"program": self.program.state_pytree(state),
                "loop": {"step": np.int64(step), **keys}}
        path = None
        if self._writer:
            path = ckpt_lib.save(self.cfg.ckpt_dir, step, tree, keep=self.cfg.ckpt_keep)
            self._emit("ckpt", step=step, path=path, seconds=round(time.time() - t0, 6))
        barrier = getattr(self.program, "barrier", None)
        if barrier is not None:
            barrier()
        return path

    def _try_resume(self, state):
        """(state, start_step, keys): restored from the latest checkpoint
        when ``resume`` is set and one exists."""
        cfg = self.cfg
        keys = self._keys()
        if not (cfg.resume and cfg.ckpt_dir):
            return state, 0, keys
        step = ckpt_lib.latest_step(cfg.ckpt_dir)
        if step is None:
            return state, 0, keys
        tree = ckpt_lib.restore(cfg.ckpt_dir, step)
        state = self.program.load_state_pytree(state, tree["program"])
        keys = {k: np.asarray(tree["loop"][k]) for k in keys}
        return state, int(tree["loop"]["step"]), keys

    def run(self) -> dict[str, Any]:
        cfg = self.cfg
        if cfg.log_jsonl and self._writer:
            self._jsonl = open(cfg.log_jsonl, "a")
        try:
            return self._run()
        finally:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None

    def _run(self) -> dict[str, Any]:
        cfg = self.cfg
        # the example batch comes from a throwaway iterator, so training
        # consumes the stream from start_step on
        state = self.program.init_state(next(self.make_loader(0)))
        state, start_step, keys = self._try_resume(state)
        loader = self.make_loader(start_step)
        cost = self.program.comm_cost()
        self._emit(
            "run_start", program=type(self.program).__name__, replicas=self.program.replicas,
            steps=cfg.steps, start_step=start_step, resumed=start_step > 0,
            comm=cost.as_dict() if cost else None,
        )
        losses: list[float] = []
        step_dts: list[float] = []
        evals: list[tuple[int, float]] = []
        weight_stds: list[tuple[int, float]] = []
        outer_syncs = comm_bytes = blocking_bytes = total_tokens = 0
        max_staleness = blocked_syncs = 0
        drain_async = getattr(self.program, "drain_async_events", None)
        drain_stream = getattr(self.program, "drain_stream_events", None)
        drain_compiles = getattr(self.program, "drain_recompile_events", None)
        recompiles = 0
        # elastic programs expose an epoch-stamped membership: a `membership`
        # event whenever the view changes (drop / rejoin)
        last_epoch = getattr(self.program, "membership_epoch", None)
        t0 = time.time()
        for t in range(start_step, cfg.steps):
            batch = next(loader)
            step_t0 = time.time()
            state, metrics = self.program.inner_step(state, batch)
            loss = float(metrics["loss"].float().mean())
            losses.append(loss)
            total_tokens += int(np.prod(batch["tokens"].shape))
            state, synced = self.program.maybe_outer_step(state)
            # a pool's first use of a membership view's entry (the replica
            # group's OuterProgramPool): one event each
            for ev in drain_compiles() if drain_compiles is not None else ():
                recompiles += 1
                self._emit("recompile", step=t + 1, **ev)
            # one event per sync: the due set, each replica's staleness τ and
            # the blocked participants (the synchronous clock emits τ = 0)
            for ev in drain_async() if drain_async is not None else ():
                max_staleness = max(max_staleness, int(ev.get("max_staleness", 0)))
                blocked_syncs += int(ev.get("blocked", 0))
                self._emit("outer_async", step=t + 1, **ev)
            epoch = getattr(self.program, "membership_epoch", None)
            if epoch != last_epoch:
                last_epoch = epoch
                mem = self.program.membership
                self._emit("membership", step=t + 1, epoch=epoch,
                           num_active=mem.num_active, active=list(mem.active_ids))
            dt = time.time() - step_t0
            step_dts.append(dt)
            self._emit(
                "step", step=t + 1, loss=loss, dt_s=round(dt, 6),
                tokens_per_s=round(total_tokens / max(time.time() - t0, 1e-9), 1),
            )
            if synced:
                outer_syncs += 1
                # a streaming program reports which stream synced and whether
                # it consumed its prefetch: the bytes follow those events
                sevents = drain_stream() if drain_stream is not None else []
                if sevents:
                    payload = sum(ev["payload_bytes"] for ev in sevents)
                    blocking = sum(ev["blocking_bytes"] for ev in sevents)
                    for ev in sevents:
                        self._emit("stream_sync", step=t + 1, **ev)
                else:
                    payload = cost.payload_bytes if cost else 0
                    blocking = cost.blocking_bytes if cost else 0
                comm_bytes += payload
                blocking_bytes += blocking
                self._emit("outer", step=t + 1, sync_index=outer_syncs,
                           payload_bytes=payload, blocking_bytes=blocking)
            if cfg.eval_every and (t + 1) % cfg.eval_every == 0 and self.eval_set:
                ev = float(np.mean([self.program.eval_step(state, b) for b in self.eval_set]))
                wstd = float(self.program.weight_std(state))
                evals.append((t + 1, ev))
                weight_stds.append((t + 1, wstd))
                self._emit("eval", step=t + 1, eval_loss=ev, weight_std=wstd)
                if cfg.log and self._writer:
                    print(f"step {t+1}: train={loss:.4f} eval={ev:.4f} "
                          f"wstd={wstd:.6f} ({time.time()-t0:.0f}s)", flush=True)
            if cfg.ckpt_dir and cfg.ckpt_every and (t + 1) % cfg.ckpt_every == 0:
                self._save(t + 1, state, keys)
        finish = getattr(self.program, "finish", None)
        if finish is not None:   # e.g. transfers still in flight are waited
            state = finish(state)
        wall = time.time() - t0
        already_saved = cfg.ckpt_every and cfg.steps % cfg.ckpt_every == 0
        if cfg.ckpt_dir and cfg.steps > start_step and not already_saved:
            self._save(cfg.steps, state, keys)
        summary = {
            "steps_run": cfg.steps - start_step,
            "start_step": start_step,
            "wall_s": wall,
            "tokens_per_s": total_tokens / max(wall, 1e-9),
            "outer_syncs": outer_syncs,
            "comm_bytes": comm_bytes,
            "blocking_bytes": blocking_bytes,
            "blocking_fraction": blocking_bytes / comm_bytes if comm_bytes else 0.0,
            "final_weight_std": float(self.program.weight_std(state)),
            "membership_epoch": last_epoch,
            "recompiles": recompiles,
            "stream_count": getattr(cost, "stream_count", 1) if cost else 1,
        }
        if drain_async is not None:
            summary["max_staleness"] = max_staleness
            summary["blocked_syncs"] = blocked_syncs
        pool = getattr(self.program, "pool_stats", lambda: None)()
        if pool is not None:
            summary["pool"] = pool
        self._emit("run_end", **summary)
        return {
            "losses": losses,
            "step_dt_s": step_dts,
            "evals": evals,
            "weight_stds": weight_stds,
            "state": state,
            "comm": cost.as_dict() if cost else None,
            **summary,
        }


def make_loop(program: TrainProgram, loader_cfg, cfg: LoopConfig, *, n_eval: int = 2) -> TrainLoop:
    """Standard loop assembly: train stream from ``loader_cfg`` (a
    :class:`repro_torch.data.LoaderConfig`), eval stream from the
    ``seed + 777`` convention."""
    from repro_torch.data import eval_batches, shard_iterator

    eval_cfg = dataclasses.replace(loader_cfg, seed=loader_cfg.seed + 777)
    return TrainLoop(
        program,
        lambda start: shard_iterator(loader_cfg, start_step=start),
        cfg,
        eval_set=eval_batches(eval_cfg, n_eval) if cfg.eval_every else [],
    )
