"""The MoE family's training against the JAX package's, on the CPU:
granite-moe-1b-a400m.reduced (2 layers, 4 experts, top-2) from the JAX
initial weights, in a file of its own so that a parallel run (one file a
worker) spreads the two packages' runs.

The loss each step reports and differentiates is the LM loss plus the
routers' load-balance loss, as in the reference.  Tolerances are
``test_torch_train.py``'s: per-step losses within 1e-4 relative, final
weight std within 1e-3 relative, identical partner tables, bytes and
telemetry.

Routing makes the free-running trajectories part.  AdamW's first step
turns last-bit differences of near-zero gradients into weight differences
of up to ~3e-4 (a few weights in each package; ``test_torch_train.py``
notes the same for the dense model), and on this seed that is enough, at
step 3, for one token of one replica to take another second expert: its
two candidates' probabilities were 5.8e-7 apart.  A flipped choice moves
that token's output by a whole expert's contribution, and the losses part
by more than 1e-4 from step 7 on.  So the whole runs hold their losses to
1e-4 up to the first step at which the two trajectories route any token
differently, found by replaying both packages' programs step by step; the
choices flipped there must be near ties (top-k margin under 1e-5), and the
count and margins are reported.  ``tests/test_torch_train_moe_locked.py``
then holds every one of the 20 steps, both outer syncs included: each step
of the port starts from the reference's state.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.kernels.dispatch import KernelConfig
from repro.launch.train import method_config as jmethod_config
from repro.train.adapters import GossipProgram as JGossipProgram
from repro_torch.data import LoaderConfig, shard_iterator
from repro_torch.launch import train as train_cli
from repro_torch.models import convert, moe
from repro_torch.models import model as M
from repro_torch.train import adapters
from test_torch_train import RUN, _configs, _jax_params, check_run_training

KIND = "granite-moe-1b-a400m.reduced"
NEAR_TIE = 1e-5       # largest top-k margin a flip between the packages may have


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: these small CPU runs gain
    nothing from more, and in a parallel test run the other workers'
    multi-device JAX subprocesses need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _programs(method, codec, monkeypatch):
    """Both packages' training programs for RUN, the port's starting from
    the JAX initial weights, and the run's batches."""
    jcfg, cfg = _configs(KIND)
    params = _jax_params(jcfg)
    monkeypatch.setattr(adapters.GossipProgram, "initial_params",
                        lambda self: convert.params_from_jax_numpy(params, cfg))
    sched = dict(inner_lr=RUN["inner_lr"], total_steps=RUN["steps"],
                 warmup=max(RUN["steps"] // 10, 1), inner_steps=RUN["inner_steps"], seed=0)
    kcfg = KernelConfig("jnp")
    jprog = JGossipProgram(
        dataclasses.replace(jcfg, kernels=kcfg),
        jmethod_config(method, comm=JCommConfig(codec=codec), kernels=kcfg, **sched),
        replicas=RUN["replicas"], seed=0)
    pprog = adapters.GossipProgram(
        cfg, train_cli.method_config(method, comm=train_cli.CommConfig(codec=codec), **sched),
        replicas=RUN["replicas"], seed=0, device="cpu")
    batches = shard_iterator(LoaderConfig(
        vocab_size=cfg.vocab_size, seq_len=RUN["seq_len"],
        per_replica_batch=RUN["per_replica_batch"], replicas=RUN["replicas"]))
    return cfg, jprog, pprog, batches


def _routing(cfg, theta, batch):
    """Every MoE layer's routing of ``batch`` under stacked ``theta``, by
    the port's forward: [(probs, top-k ids)] in layer order."""
    seen = []

    def spy(router, xt, k):
        out = real(router, xt, k)
        seen.append((out[0], out[2]))
        return out

    real = moe.route
    moe.route = spy
    try:
        with torch.no_grad():
            M.stacked_loss(theta, cfg, batch)
    finally:
        moe.route = real
    return seen


def _flips(cfg, jtheta, ptheta, batch):
    """Routing decisions that differ between the two packages' weights on
    ``batch``: (count, top-k margins of the flipped tokens under the
    reference's weights)."""
    count, margins = 0, []
    k = cfg.num_experts_per_token
    for (probs, want), (_, got) in zip(_routing(cfg, jtheta, batch), _routing(cfg, ptheta, batch)):
        differ = (want != got).any(dim=-1)
        count += int(differ.sum())
        srt = probs.sort(dim=-1, descending=True).values
        margins += (srt[..., k - 1] - srt[..., k])[differ].tolist()
    return count, margins


def _host_tree(jprog, jst):
    return jax.tree.map(np.asarray, jprog.state_pytree(jst))


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _free_run(method):
    """Both programs free-running over RUN's steps (the trajectory of
    ``run_training``) up to the first step whose forward routes a token
    differently: per-step losses of each before it, and that step with the
    count and margins of its differing decisions (None if none)."""
    mp = pytest.MonkeyPatch()
    try:
        cfg, jprog, pprog, batches = _programs(method, "none", mp)
        b0 = next(shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=RUN["seq_len"],
                                              per_replica_batch=RUN["per_replica_batch"],
                                              replicas=RUN["replicas"])))
        jst, pst = jprog.init_state(b0), pprog.init_state(b0)
        jl, pl, first = [], [], None
        for step in range(1, RUN["steps"] + 1):
            b = next(batches)
            jtheta = convert.train_state_from_jax_numpy(_host_tree(jprog, jst), cfg).theta
            count, margins = _flips(cfg, jtheta, pst.theta, _torch_batch(b))
            if count:
                first = (step, count, margins)
                break
            jst, jm = jprog.inner_step(jst, {k: jnp.asarray(v) for k, v in b.items()},
                                       jax.random.PRNGKey(0))
            pst, pm = pprog.inner_step(pst, b)
            jl.append(float(jnp.mean(jm["loss"])))
            pl.append(float(pm["loss"].mean()))
            jst, _ = jprog.maybe_outer_step(jst)
            pst, _ = pprog.maybe_outer_step(pst)
    finally:
        mp.undo()
    return jl, pl, first


@pytest.mark.parametrize("method", ["noloco"])
def test_run_training_matches_jax(method, tmp_path, monkeypatch):
    """run_training from the JAX initial weights: partner tables, bytes and
    telemetry identical; losses within 1e-4 relative over every step before
    the first routing flip (all 20 steps if there is none), and a flip only
    on a near tie.  The other methods' and the int8 wire's steps are held
    one by one in ``tests/test_torch_train_moe_locked.py``."""
    jl, pl, first = _free_run(method)
    held = RUN["steps"] if first is None else first[0] - 1
    if first is not None:
        step, count, margins = first
        print(f"{method}: first routing flip at step {step}: {count} decisions, "
              f"top-k margins {margins}")
        assert max(margins) < NEAR_TIE, margins
    got, want = check_run_training(method, KIND, tmp_path, monkeypatch, held=held)
    # the replayed programs are the runs' trajectories
    np.testing.assert_allclose(want["losses"][:held], jl, rtol=1e-6)
    np.testing.assert_allclose(got["losses"][:held], pl, rtol=1e-6)


def test_first_flip_is_the_measured_near_tie():
    """The free-running NoLoCo trajectories route identically through step
    2; at step 3 one decision differs, on a margin under 1e-6."""
    _, _, first = _free_run("noloco")
    assert first is not None and first[0] == 3 and first[1] == 1 and first[2][0] < 1e-6
