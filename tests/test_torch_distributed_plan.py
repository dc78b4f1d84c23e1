"""The replica group's pairings, plans, refusals and CLI, on the CPU.

The port's ``ppermute_pairs`` and ``hypercube_ppermute_pairs`` equal JAX's
for every step below 64, worlds 2–8 (the hypercube's powers of two) and
two seeds; the pool's slots, pairs and bound equal JAX's
``OuterProgramPool``'s.  ``make_plan`` runs ``gossip_dp`` at model-axis
size 1 and refuses the model axis by name, the CLI refuses the deferred
flags before it starts a rank, and ``--backend nccl`` refuses more ranks
than cards, naming ``--backend gloo``.  Then the CLI itself on three CPU
ranks (a world in which one rank pairs with itself every round), its
per-rank losses bit for bit those of the port's stacked program on the
same objective, its summary the reference's keys plus ``method``,
``device`` and ``backend``.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import OuterConfig, pairing
from repro_torch.launch import mesh, train_distributed
from repro_torch.parallel import plans, steps

SEEDS = (0, 3)


def test_pairs_match_the_reference():
    from repro.core import pairing as jpairing

    for seed in SEEDS:
        for world in range(2, 9):
            for step in range(64):
                assert pairing.ppermute_pairs(step, world, seed=seed) == \
                    jpairing.ppermute_pairs(step, world, seed=seed), (seed, world, step)
                if world & (world - 1) == 0:
                    assert pairing.hypercube_ppermute_pairs(step, world, seed=seed) == \
                        jpairing.hypercube_ppermute_pairs(step, world, seed=seed)


@pytest.mark.parametrize("schedule", ["random", "hypercube"])
def test_pool_matches_the_reference(schedule):
    from repro.core.outer import OuterConfig as JOuterConfig
    from repro.parallel.plans import Plan as JPlan
    from repro.parallel.steps import OuterProgramPool as JPool

    for world in (2, 4, 8):
        jplan = JPlan(name="gossip_dp", mesh_axes=("data", "model"), replica_axes=("data",),
                      tp=1, replicas=world)
        jpool = JPool(jplan, None, None, JOuterConfig(), schedule=schedule, pairing_pool=3,
                      seed=5)
        pool = steps.OuterProgramPool(plans.make_plan("gossip_dp", world), OuterConfig(),
                                      group=None, schedule=schedule, pairing_pool=3, seed=5)
        assert pool.max_programs_per_view == jpool.max_programs_per_view
        for i in range(12):
            assert pool.pool_slot(i) == jpool.pool_slot(i)
            assert pool.pairs_for(i) == jpool.pairs_for(i)
        assert pool.view_key(None) is None and pool.stats() == dict(
            jpool.stats(), schedule=schedule)


def test_pool_counts_first_uses_and_refuses_partial_views():
    pool = steps.OuterProgramPool(plans.make_plan("gossip_dp", 4), OuterConfig(), group=None,
                                  pairing_pool=2)
    misses = []
    for i in range(5):
        pool.program(i)
        misses.append(pool.stats()["misses"])
    assert misses == [1, 2, 2, 2, 2]
    assert pool.program(4) is pool.program(2) is not pool.program(1)
    assert pool.stats() == {"pool_size": 2, "hits": 6, "misses": 2, "schedule": "random",
                            "max_programs_per_view": 2}
    # a partial view keys programs of its own, which the full-membership
    # pool never builds; the CLI refuses fault plans (item 9b)
    partial = pairing.Membership.full(4).drop([1])
    assert pool.view_key(partial) == ((True, False, True, True), None)
    with pytest.raises(NotImplementedError, match="item 9b"):
        train_distributed.main(["--device", "cpu", "--fault-plan", "plan.json"])


def test_plans():
    plan = plans.make_plan("gossip_dp", 4)
    assert (plan.replicas, plan.tp, plan.fsdp, plan.world) == (4, 1, 1, 4)
    assert [plan.replica_of(r) for r in range(4)] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        plan.replica_of(4)
    with pytest.raises(NotImplementedError, match="item 9c"):
        plans.make_plan("gossip_dp", 4, 2)
    with pytest.raises(NotImplementedError, match="item 9c"):
        plans.make_plan("fsdp_hybrid", 4)
    with pytest.raises(ValueError):
        plans.make_plan("zero", 4)


@pytest.mark.parametrize("flags, item", [
    (["--model", "2"], "item 9c"), (["--fault-plan", "plan.json"], "item 9b"),
    (["--reassign-data"], "item 9b"), (["--stale", "momentum"], "item 9b"),
    (["--overlap"], "item 9b"), (["--stream-count", "2"], "item 9b")])
def test_cli_refuses_the_deferred_flags(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        train_distributed.main(["--device", "cpu", *flags])


def test_backends(monkeypatch):
    with pytest.raises(RuntimeError, match="--device cpu"):   # no card here
        mesh.check_backend("gloo", 4, "cuda")
    with pytest.raises(ValueError, match="--backend gloo"):
        mesh.check_backend("nccl", 4, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--backend gloo"):
        mesh.check_backend("nccl", 4, "cuda")
    with pytest.raises(ValueError, match="--backend gloo"):
        train_distributed.main(["--backend", "nccl", "--data", "4"])
    assert mesh.check_backend("nccl", 1, "cuda").type == "cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        mesh.check_backend("mpi", 2, "cpu")


REFERENCE_KEYS = {"arch", "replicas", "tp", "codec", "fuse", "overlap", "stream_count",
                  "blocking_fraction", "final_loss", "final_eval", "tokens_per_s", "comm_bytes",
                  "wall_s", "pool", "recompiles"}


def test_cli_on_three_ranks_equals_the_stacked_program(tmp_path, capsys):
    from repro_torch.comm import CommConfig
    from repro_torch.configs import registry
    from repro_torch.core import TrainerConfig
    from repro_torch.data import LoaderConfig, shard_iterator
    from repro_torch.models import model as model_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import adapters

    world, m, n_steps = 3, 2, 6
    out = tmp_path / "out.json"
    summary = train_distributed.main([
        "--device", "cpu", "--backend", "gloo", "--reduced", "--data", str(world),
        "--steps", str(n_steps), "--inner-steps", str(m), "--seq", "16",
        "--batch-per-replica", "2", "--pairing-pool", "4", "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert REFERENCE_KEYS | {"method", "device", "backend"} == set(summary)
    assert (summary["device"], summary["backend"], summary["replicas"]) == ("cpu", "gloo", 3)
    assert summary["pool"]["misses"] == n_steps // m
    got = json.loads(out.read_text())
    partners = got["partners"]
    assert len(partners) == n_steps // m
    assert all(sum(p[i] == i for i in range(world)) == 1 for p in partners)   # one sits out

    cfg = registry.get_config("paper-small-125m")
    cfg = cfg.reduced(vocab_size=min(cfg.vocab_size, 512), remat=False, dtype="float32")
    tcfg = TrainerConfig(outer=OuterConfig(method="noloco", alpha=0.5, beta=0.7, inner_steps=m),
                         inner=AdamWConfig(lr=2e-3, weight_decay=0.0), comm=CommConfig())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        program = adapters.GossipProgram(cfg, tcfg, replicas=world, device="cpu")
        program.trainer.loss_fn = lambda p, b: model_api.stacked_loss(p, cfg, b) / world
        loader = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                             per_replica_batch=2, replicas=world))
        state = program.init_state(None)
        losses = np.asarray(got["losses"], dtype=np.float32).T   # (steps, R)
        for t in range(n_steps):
            state, metrics = program.inner_step(state, next(loader))
            assert np.array_equal(metrics["loss"].numpy(), losses[t] / np.float32(world)), t
            state, _ = program.maybe_outer_step(state)
    finally:
        torch.set_num_threads(threads)
    assert [p.tolist() for p in program.partners] == partners


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cli_on_the_card_equals_the_cpu(tmp_path, cuda):
    """Four gloo ranks sharing the card (the payload staged through pinned
    host memory) against four CPU ranks: the same partner tables, losses
    within 1e-4 relative."""
    runs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        train_distributed.main(["--device", device, "--backend", "gloo", "--reduced",
                                "--data", "4", "--steps", "6", "--inner-steps", "2", "--seq", "32",
                                "--out", str(out)])
        runs[device] = json.loads(out.read_text())
    assert runs["cuda"]["partners"] == runs["cpu"]["partners"]
    np.testing.assert_allclose(runs["cuda"]["losses"], runs["cpu"]["losses"], rtol=1e-4)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_group_starts_with_a_barrier(monkeypatch, backend):
    """A barrier that every rank joins is the group's first call, so that no
    first ``batch_isend_irecv`` goes without a rank (a rank paired with
    itself in an odd world sits the exchange out)."""
    seen = []
    monkeypatch.setattr(mesh, "check_backend", lambda b, w, d: torch.device(
        "cuda" if b == "nccl" else "cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(mesh.dist, "init_process_group", lambda *a, **k: seen.append("init"))
    monkeypatch.setattr(mesh.dist, "barrier", lambda **k: seen.append(("barrier", k)))
    group = mesh.init_replica_group(3, backend, "cuda", rank=2, init_method="file:///x")
    want = {"device_ids": [2]} if backend == "nccl" else {}
    assert seen == ["init", ("barrier", want)]
    assert (group.rank, group.world, group.backend, group.clock) == (2, 3, backend, None)
