"""The training loop (the port of ``repro/train/loop.py``).

Owns the runtime-agnostic half of training: the step loop with its eval
cadence, wall-clock and tokens/s accounting, comm-bytes accounting from
:mod:`repro_torch.comm.bytes_model` (per outer sync: payload and blocking
bytes), and the JSONL telemetry stream with the JAX package's schema
(``run_start`` / ``step`` / ``outer`` / ``eval`` / ``run_end``, one JSON
object per line) and the same run summary.  Checkpoint and resume come with
the checkpoint reader (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch.train.program import TrainProgram

__all__ = ["LoopConfig", "TrainLoop", "make_loop"]


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Runtime-agnostic knobs of the training loop."""

    steps: int
    eval_every: int = 0         # 0: never evaluate mid-run
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

    def _emit(self, event: str, **fields) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"event": event, "run": self.cfg.run_name, **fields}) + "\n")
        self._jsonl.flush()

    def run(self) -> dict[str, Any]:
        cfg = self.cfg
        if cfg.log_jsonl:
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
        # consumes the stream from step 0 on
        state = self.program.init_state(next(self.make_loader(0)))
        loader = self.make_loader(0)
        cost = self.program.comm_cost()
        epoch = getattr(self.program, "membership_epoch", None)
        self._emit(
            "run_start", program=type(self.program).__name__, replicas=self.program.replicas,
            steps=cfg.steps, start_step=0, resumed=False,
            comm=cost.as_dict() if cost else None,
        )
        losses: list[float] = []
        evals: list[tuple[int, float]] = []
        weight_stds: list[tuple[int, float]] = []
        outer_syncs = comm_bytes = blocking_bytes = total_tokens = 0
        t0 = time.time()
        for t in range(cfg.steps):
            batch = next(loader)
            step_t0 = time.time()
            state, metrics = self.program.inner_step(state, batch)
            loss = float(metrics["loss"].float().mean())
            losses.append(loss)
            total_tokens += int(np.prod(batch["tokens"].shape))
            state, synced = self.program.maybe_outer_step(state)
            dt = time.time() - step_t0
            self._emit(
                "step", step=t + 1, loss=loss, dt_s=round(dt, 6),
                tokens_per_s=round(total_tokens / max(time.time() - t0, 1e-9), 1),
            )
            if synced:
                outer_syncs += 1
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
                if cfg.log:
                    print(f"step {t+1}: train={loss:.4f} eval={ev:.4f} "
                          f"wstd={wstd:.6f} ({time.time()-t0:.0f}s)", flush=True)
        wall = time.time() - t0
        summary = {
            "steps_run": cfg.steps,
            "start_step": 0,
            "wall_s": wall,
            "tokens_per_s": total_tokens / max(wall, 1e-9),
            "outer_syncs": outer_syncs,
            "comm_bytes": comm_bytes,
            "blocking_bytes": blocking_bytes,
            "blocking_fraction": blocking_bytes / comm_bytes if comm_bytes else 0.0,
            "final_weight_std": float(self.program.weight_std(state)),
            "membership_epoch": epoch,
            "recompiles": 0,
            "stream_count": getattr(cost, "stream_count", 1) if cost else 1,
        }
        self._emit("run_end", **summary)
        return {
            "losses": losses,
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
