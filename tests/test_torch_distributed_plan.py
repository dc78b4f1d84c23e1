"""The replica group's pairings, plans, refusals and CLI, on the CPU.

The port's ``ppermute_pairs`` and ``hypercube_ppermute_pairs`` equal JAX's
for every step below 64, worlds 2–8 (the hypercube's powers of two) and
two seeds; the pool's slots, pairs and bound equal JAX's
``OuterProgramPool``'s, for the full membership and for the partial,
partitioned, asynchronous and streamed views that the elastic, async and
streamed flags put the pool through.  ``make_plan`` runs ``gossip_dp``
with a model axis (rank r: model index r % tp of replica r // tp) and
lays out ``fsdp_hybrid`` (the pods are the replicas, the data ranks split
each one); the CLI runs ``--model 2`` and refuses it with an item-9b flag,
naming item 9e, before it starts a rank;
``--backend nccl`` refuses more ranks than cards, naming ``--backend
gloo``.  Then the CLI itself on three CPU
ranks (a world in which one rank pairs with itself every round), its
per-rank losses bit for bit those of the port's stacked program on the
same objective, its summary the reference's keys plus ``method``,
``device`` and ``backend``.
"""
import contextlib
import dataclasses
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
    """First uses are misses, later ones hits; a partial view (elastic
    rounds) keys entries of its own, which the full membership never
    shares, and two epochs with the same mask share theirs."""
    pool = steps.OuterProgramPool(plans.make_plan("gossip_dp", 4), OuterConfig(), group=None,
                                  pairing_pool=2)
    misses = []
    for i in range(5):
        pool.program(i)
        misses.append(pool.stats()["misses"])
    assert misses == [1, 2, 2, 2, 2]
    assert pool.program(4)[0] is pool.program(2)[0] is not pool.program(1)[0]
    assert pool.stats() == {"pool_size": 2, "hits": 6, "misses": 2, "schedule": "random",
                            "max_programs_per_view": 2}
    partial = pairing.Membership.full(4).drop([1])
    assert pool.view_key(partial) == ((True, False, True, True), None)
    fn, info = pool.program(2, partial)
    assert info["compiled"] and info["key"] == (((True, False, True, True), None), 0)
    assert fn is not pool.program(2)[0]
    again = partial.add([1]).drop([1])   # a later epoch, the same mask
    assert again.epoch != partial.epoch and pool.program(0, again)[0] is fn
    assert [e["view"] for e in pool.drain_events()] == ["full", "full", "elastic"]


def test_plans():
    plan = plans.make_plan("gossip_dp", 4)
    assert (plan.replicas, plan.tp, plan.fsdp, plan.world) == (4, 1, 1, 4)
    assert [plan.replica_of(r) for r in range(4)] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        plan.replica_of(4)
    plan = plans.make_plan("gossip_dp", 4, 2)
    assert (plan.replicas, plan.tp, plan.fsdp, plan.world) == (4, 2, 1, 8)
    assert [(plan.replica_of(r), plan.model_index_of(r)) for r in range(8)] == [
        (rep, m) for rep in range(4) for m in range(2)]
    with pytest.raises(ValueError):
        plan.replica_of(8)
    plan = plans.make_plan("fsdp_hybrid", 4)
    assert (plan.replicas, plan.tp, plan.fsdp, plan.world) == (1, 1, 4, 4)
    assert [(plan.replica_of(r), plan.data_index_of(r)) for r in range(4)] == [
        (0, d) for d in range(4)]
    plan = plans.make_plan("fsdp_hybrid", 2, pod=2)
    assert (plan.replicas, plan.tp, plan.fsdp, plan.world) == (2, 1, 2, 4)
    assert [(plan.replica_of(r), plan.data_index_of(r)) for r in range(4)] == [
        (p, d) for p in range(2) for d in range(2)]
    with pytest.raises(ValueError):
        plans.make_plan("zero", 4)


@pytest.fixture
def jax_pool(monkeypatch):
    """JAX's ``OuterProgramPool`` with its program builder stubbed (no mesh
    to compile on): its keys, pairs, stats and events alone."""
    from repro.core.outer import OuterConfig as JOuterConfig
    from repro.parallel import steps as jsteps
    from repro.parallel.plans import Plan as JPlan

    monkeypatch.setattr(jsteps, "build_outer_step", lambda *a, **k: object())
    monkeypatch.setattr(jsteps.compat, "set_mesh", lambda mesh: contextlib.nullcontext())

    def make(comm, partition):
        from repro.comm import CommConfig as JCommConfig

        jplan = JPlan(name="gossip_dp", mesh_axes=("data", "model"), replica_axes=("data",),
                      tp=1, replicas=4)
        return jsteps.OuterProgramPool(jplan, None, None, JOuterConfig(),
                                       comm_cfg=JCommConfig(**comm), pairing_pool=3, seed=2,
                                       partition=partition)

    return make


FULL = pairing.Membership.full(4)
# each item-9b flag and the pool calls its rounds make: a dropped replica, a
# partition, an asynchronous tick, the overlap's one stream, two streams
VIEWS = {
    "--fault-plan": ({}, [dict(membership=FULL.drop([1])),
                          dict(membership=FULL.drop([1]).drop([2]))]),
    "--reassign-data": ({}, [dict(membership=FULL.drop([3])),
                             dict(membership=FULL, groups=[[0, 1], [2, 3]])]),
    "--stale": ({}, [dict(membership=FULL, update_mask=[True, False, True, True],
                          staleness=[0, 1, 0, 0]),
                     dict(membership=FULL.drop([0]), update_mask=[False, True, True, False])]),
    "--overlap": ({"overlap": True}, [
        dict(stream=0, consume=False, presend_index=1, presend_membership=FULL),
        dict(membership=FULL.drop([2]), stream=0, consume=True, presend_index=1,
             presend_membership=FULL)]),
    "--stream-count": ({"overlap": True, "streams": 2}, [
        dict(stream=1, consume=True, presend_index=3, presend_membership=FULL.drop([2])),
        dict(membership=FULL.drop([2]), groups=[[0, 1], [2, 3]], stream=0, consume=False,
             presend_index=2, presend_membership=FULL.drop([2]))]),
}


@pytest.mark.parametrize("flags, item", [
    (["--model", "2"], "item 9c"), (["--fault-plan", "plan.json"], "item 9b"),
    (["--reassign-data"], "item 9b"), (["--stale", "momentum"], "item 9b"),
    (["--overlap"], "item 9b"), (["--stream-count", "2"], "item 9b")])
def test_cli_refuses_the_deferred_flags(flags, item, jax_pool, capsys):
    """The model axis (item 9c) runs: two replicas of two model ranks on
    four CPU ranks, the summary's ``tp`` the plan's.  Each item-9b flag is
    accepted at ``--model 1``: the trainer the CLI builds carries it, and
    the pool keys the views its rounds take (partial, partitioned,
    asynchronous, streamed) as JAX's pool does: the same pairs, keys, view
    keys, stats and first-use events; with ``--model 2`` it is refused,
    naming item 9e."""
    from repro.comm import stream_partition as jstream_partition
    from repro_torch.comm import payload

    if item == "item 9c":
        summary = train_distributed.main(
            ["--device", "cpu", "--reduced", "--data", "2", "--steps", "2", "--inner-steps", "2",
             "--seq", "16", *flags])
        assert summary["tp"] == 2 and summary["replicas"] == 2
        assert np.isfinite(summary["final_loss"])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
        return
    with pytest.raises(NotImplementedError, match="item 9e"):
        train_distributed.main(["--device", "cpu", "--model", "2", *flags])
    args = train_distributed.build_parser().parse_args(["--device", "cpu", *flags])
    train_distributed.check_args(args)
    group = mesh.ReplicaGroup(rank=0, world=4, device=torch.device("cpu"), backend="gloo")
    trainer = train_distributed.make_trainer(args, group, plans_cfg())
    comm, calls = VIEWS[flags[0]]
    assert (trainer.elastic is not None) == (flags[0] == "--fault-plan")
    assert trainer.comm_cfg.overlap == comm.get("overlap", False)
    assert trainer.comm_cfg.streams == comm.get("streams", 1)
    assert trainer.outer_cfg.stale == ("momentum" if flags[0] == "--stale" else "naive")
    assert args.reassign_data == (flags[0] == "--reassign-data")

    tree = {"a": np.zeros((4, 6), np.float32), "b": np.zeros((4, 10), np.float32)}
    streams = comm.get("streams", 1)
    jpool = jax_pool(comm, jstream_partition(tree, streams) if comm else None)
    pool = steps.OuterProgramPool(
        plans.make_plan("gossip_dp", 4), OuterConfig(), group=group,
        comm_cfg=train_distributed.CommConfig(**comm), pairing_pool=3, seed=2,
        partition=payload.stream_partition(tree, streams) if comm else None)
    assert pool.max_programs_per_view == jpool.max_programs_per_view
    for i in range(4):
        for call in calls * 2:
            mem, groups = call.get("membership"), call.get("groups")
            assert pool.view_key(mem, groups) == jpool.view_key(mem, groups)
            assert pool.pairs_for(i, mem, groups) == jpool.pairs_for(i, mem, groups)
            kw = {k: v for k, v in call.items() if k not in ("membership", "groups")}
            got = pool.program(i, mem, groups, **kw)[1]
            want = jpool.program(i, mem, groups, **kw)[1]
            assert got["key"] == want["key"] and got["compiled"] == want["compiled"]
    assert pool.stats() == jpool.stats()
    drop = lambda evs: [{k: v for k, v in e.items() if k != "build_s"} for e in evs]
    assert drop(pool.drain_events()) == drop(jpool.drain_events())


@pytest.mark.parametrize("method", ["fsdp", "none"])
def test_cli_refuses_a_fault_plan_without_an_outer_method(method, capsys):
    """Under a fault plan a replica that sits a step out skips the step's
    gradient all-reduce, which would leave ``--method fsdp``'s other ranks
    waiting in it; the group refuses the methods the stacked elastic CLI
    refuses, with its message, and the trainer refuses them too."""
    from repro_torch.core.elastic import ElasticContext
    from repro_torch.launch import train_elastic

    with pytest.raises(SystemExit) as stacked:
        train_elastic.build_parser().parse_args(["--method", method])
    want = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    assert stacked.value.code == 2 and "invalid choice" in want
    argv = ["--device", "cpu", "--method", method, "--fault-plan", "plan.json"]
    with pytest.raises(SystemExit, match="invalid choice") as group:
        train_distributed.main(argv)
    assert str(group.value.code) == want
    args = train_distributed.build_parser().parse_args(argv)
    group4 = mesh.ReplicaGroup(rank=0, world=4, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="elastic run takes method noloco or diloco"):
        train_distributed.make_trainer(args, group4, plans_cfg())
    args.fault_plan = None
    trainer = train_distributed.make_trainer(args, group4, plans_cfg())
    assert trainer.elastic is None and trainer.data_sync == (method == "fsdp")
    with pytest.raises(ValueError, match="elastic run"):
        dataclasses.replace(trainer, elastic=ElasticContext(world=4))


def plans_cfg():
    from repro_torch.configs import registry

    return registry.get_config("paper-small-125m").reduced(vocab_size=512, remat=False,
                                                           dtype="float32")


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
