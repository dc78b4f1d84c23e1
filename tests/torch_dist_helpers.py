"""Shared pieces of the replica-group tests (``tests/test_torch_distributed*.py``):
the TINY run both packages make, the JAX reference run in a subprocess on
four forced host devices, and the port's rank function that the tests
spawn on four ``gloo`` CPU ranks.

The rank function counts every ``torch.distributed`` call the runtime makes,
split into those made inside inner steps and inside outer steps, by
wrapping the module's functions in the rank's process.  It imports no JAX:
the spawned ranks run the port alone.
"""
import argparse
import collections
import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 4
# tests/test_multidevice.py's config
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            dtype="float32", remat=False)
# 8 steps of m = 2: four rounds, so a pairing pool of 2 cycles its slots
RUN = dict(steps=8, inner_steps=2, batch_per_replica=2, seq=16, lr=2e-3, pairing_pool=2)
MID = 4
LOSS_RTOL = 1e-4
PHI_ATOL = 1e-5
# the int8 wire couples every value of a 1024-value chunk through its min and
# max, so a last-bit difference of the two packages may move a code of the
# partner's φ, which the γ term carries into φ′ and the next inner steps
# into every weight: the losses are held to the stacked int8 tests' 1e-4,
# φ to INT8_NEAR except for at most a share INT8_MOVED of its values, each
# within INT8_PHI_ATOL (two code steps of a chunk of range 0.25).  On TINY
# 20 of 361,728 values lie beyond 1e-4, the largest 1.005e-3 off.
# runs through churn (a drop, a warm start, 16–22 steps): a few values (the
# same elements in every replica: an embedding entry, an MLP column) end
# 1.2e-5 to 1.55e-5 from JAX's, near-zero gradients whose last bits differ
# and which AdamW's normalisation turns into a fraction of a step, while
# every loss stays within 2.3e-7 relative.  JAX's own runs of those plans
# move φ by 5.8e-5 to 9.0e-5 when only XLA's threading changes
# (--xla_cpu_multi_thread_eigen=false), so their φ is held to twice
# PHI_ATOL.
CHURN_PHI_ATOL = 2 * PHI_ATOL
INT8_NEAR = 1e-4
INT8_PHI_ATOL = 2e-3
INT8_MOVED = 1e-3

JAX_SCRIPT = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import jax
    from repro.comm import CommConfig
    from repro.configs import registry as JR
    from repro.core.elastic import ElasticContext
    from repro.core.outer import OuterConfig
    from repro.data import LoaderConfig
    from repro.launch.mesh import make_test_mesh
    from repro.launch.train_distributed import DistributedTrainer
    from repro.models import model as M
    from repro.models.common import values_of
    from repro.models.config import ModelConfig
    from repro.optim import AdamWConfig
    from repro.parallel import plans as PL
    from repro.parallel import steps as ST
    from repro.sim import FaultPlan, SimCluster
    from repro.train import DistributedProgram, LoopConfig, make_loop

    spec = pickle.load(open(sys.argv[1], "rb"))
    tiny, run = spec["tiny"], spec["run"]
    tiny_cfg = ModelConfig(**tiny)
    data, pod = spec.get("data", 4), spec.get("pod")
    meshes = {}
    def mesh_plan(model):   # a case may set its own model axis
        if model not in meshes:
            mesh = make_test_mesh(data, model, pod=pod)
            meshes[model] = (mesh, PL.make_plan(spec.get("plan", "gossip_dp"), mesh,
                                                 shape_kind="train"))
        return meshes[model]
    replicas = mesh_plan(spec.get("model", 1))[1].replicas

    # every case starts from the same weights and compiles the same train
    # step: draw the one and build the other once.  A run that resumes
    # draws its weights in a jit (their values are replaced)
    if spec.get("params") is not None:   # the caller's weights (numpy, JAX's layout)
        from repro.models.common import Param
        drawn = jax.jit(M.init_params, static_argnums=1)(jax.random.PRNGKey(0), tiny_cfg)
        init = jax.tree.map(lambda p, v: Param(jax.numpy.asarray(v), p.logical), drawn,
                            spec["params"], is_leaf=lambda x: isinstance(x, Param))
    elif spec.get("resumed_only"):
        init = jax.jit(M.init_params, static_argnums=1)(jax.random.PRNGKey(0), tiny_cfg)
    else:
        init = M.init_params(jax.random.PRNGKey(0), tiny_cfg)
    # a case may train a registry arch's reduced() config instead of TINY,
    # from the caller's weights (the case's "params")
    inits = {tiny_cfg.name: init}
    _init = M.init_params
    M.init_params = lambda key, c: inits[c.name]
    def config(case):
        arch = case.get("arch")
        return tiny_cfg if arch is None else JR.get_config(arch).reduced(dtype="float32",
                                                                          remat=False)
    _build = ST.build_train_step
    _bundles = {}
    sync = {"on": False}   # the FSDP baseline's step: the gradients meaned over replicas
    def build_once(*a, **k):
        key = (sync["on"], id(a[2]), a[0].name)   # a[0]: the config, a[2]: the mesh
        if key not in _bundles:
            _bundles[key] = _build(*a, **dict(k, data_sync=sync["on"]))
        return _bundles[key]
    ST.build_train_step = build_once

    out = {"params": jax.tree.map(np.asarray, values_of(init))}
    for name, case in spec["cases"]:
        method = case.get("method", "noloco")
        steps = case.get("steps", run["steps"])
        m = case.get("inner_steps", run["inner_steps"])
        data_sync = False
        if method == "fsdp":   # the CLI's baseline: gradients all-reduced, no outer step
            method, m, data_sync = "none", 10**9, True
        streams = case.get("streams", 1)
        events = case.get("events")
        elastic = None if events is None else ElasticContext(world=replicas)
        mesh, plan = mesh_plan(case.get("model", spec.get("model", 1)))
        cfg = config(case)
        if case.get("params") is not None:
            from repro.models.common import Param
            shapes = jax.eval_shape(lambda: _init(jax.random.PRNGKey(0), cfg))
            inits[cfg.name] = jax.tree.map(lambda p, v: Param(jax.numpy.asarray(v), p.logical),
                                           shapes, case["params"],
                                           is_leaf=lambda x: isinstance(x, Param))
        tr = DistributedTrainer(
            cfg=cfg, mesh=mesh, plan=plan,
            outer_cfg=OuterConfig(method=method, alpha=0.3 if method == "diloco" else 0.5,
                                  beta=0.7, inner_steps=m, stale=case.get("stale", "naive")),
            inner_cfg=AdamWConfig(lr=run["lr"], weight_decay=0.0),
            comm_cfg=CommConfig(codec=case.get("codec", "none"),
                                overlap=case.get("overlap", streams > 1), streams=streams),
            schedule=case.get("schedule", "random"),
            pairing_pool=case.get("pairing_pool", run["pairing_pool"]), seed=0, elastic=elastic)
        sync["on"] = data_sync
        # every replica's loss of every step, NaN where the replica sat it out
        rec = []
        def recorded(state, batch, inner=tr.inner_step, rec=rec, elastic=elastic):
            mask = None if elastic is None else elastic.active_array()
            state, met = inner(state, batch)
            loss = np.asarray(met["loss"], dtype=np.float32)
            rec.append(loss if mask is None else np.where(mask, loss, np.nan))
            return state, met
        tr.inner_step = recorded
        prog = DistributedProgram(tr)
        sim = None if events is None else SimCluster(
            prog, FaultPlan.build(events), reassign_data=case.get("reassign", False),
            async_clock=case.get("async_clock"))
        loop = make_loop(
            sim or prog, LoaderConfig(vocab_size=cfg.vocab_size, seq_len=run["seq"],
                                      per_replica_batch=run["batch_per_replica"],
                                      replicas=replicas, seed=0),
            LoopConfig(steps=steps, seed=0, ckpt_dir=case.get("ckpt_dir"),
                       ckpt_every=case.get("ckpt_every", 0), resume=case.get("resume", False),
                       log_jsonl=case.get("log_jsonl")))
        res = loop.run()
        st = res["state"]
        rounds = steps // m
        out[name] = {
            "losses": np.stack(rec), "start_step": res["start_step"],
            "partners": [np.asarray([d for _, d in tr.pool.pairs_for(i)[1]])
                         for i in range(rounds)] if method == "noloco" else [],
            "phi": jax.tree.map(np.asarray, st["phi"]),
            "theta": jax.tree.map(np.asarray, st["theta"]),
            "wstd": res["final_weight_std"], "pool": tr.pool.stats(),
            "rounds": None if sim is None else sim.rounds(),
            "summary": {k: res.get(k) for k in ("max_staleness", "blocked_syncs", "recompiles",
                                                 "comm_bytes", "blocking_bytes", "outer_syncs")}}
    pickle.dump(out, open(sys.argv[2], "wb"))
''')


def jax_env(devices: int, fast_compile: bool = False) -> dict:
    """The environment of a JAX subprocess on ``devices`` forced host
    devices, XLA at its lowest optimisation level; ``fast_compile`` also
    turns off XLA's CPU fusion emitters, which cuts a short run's compile
    time by about a fifth."""
    flags = (f"--xla_force_host_platform_device_count={devices} "
             "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true")
    if fast_compile:
        flags += " --xla_cpu_use_fusion_emitters=false"
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)


def jax_reference(tmp, cases, **kw) -> dict:
    """:func:`start_jax_reference` and its result."""
    return start_jax_reference(tmp, cases, **kw).result()


class Pending:
    """A JAX script running in a subprocess (:func:`start_script`):
    :meth:`result` waits for it and loads what it pickled."""

    def __init__(self, proc, out, log):
        self.proc, self.out, self.log = proc, out, log

    def result(self) -> dict:
        self.proc.wait(timeout=300)
        with open(self.log) as f:
            assert self.proc.returncode == 0, f.read()
        with open(self.out, "rb") as f:
            return pickle.load(f)


def start_script(script: str, spec: dict, tmp: str, devices: int, *, name: str = "jax",
                 fast_compile: bool = False) -> Pending:
    """Start ``script`` (it reads the pickled ``spec`` from argv[1] and
    pickles its result to argv[2]) in a subprocess on ``devices`` forced
    host devices (:func:`jax_env`), its files ``<name>.*`` under ``tmp``, and
    return at once: the port's ranks may run meanwhile."""
    spec_path, out = os.path.join(tmp, f"{name}.spec.pkl"), os.path.join(tmp, f"{name}.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    log = os.path.join(tmp, f"{name}.log")
    with open(log, "w") as f:   # a file, not a pipe: nobody reads it while the run goes on
        proc = subprocess.Popen([sys.executable, "-c", script, spec_path, out],
                                env=jax_env(devices, fast_compile), stdout=f,
                                stderr=subprocess.STDOUT)
    return Pending(proc, out, log)


def start_jax_reference(tmp, cases, *, resumed_only=False, params=None, data=4, model=1,
                        pod=None, plan="gossip_dp", fast_compile=False) -> Pending:
    """``cases`` [(name, {method, codec, schedule, ckpt_dir, ckpt_every,
    resume})] through JAX's ``DistributedTrainer`` on ``make_test_mesh(4, 1)``
    in one subprocess (XLA at its lowest optimisation level: the run is
    short and compiles dominate it).  Its threading stays XLA's default:
    with one intra-op thread its reductions sum in another order and a few
    φ values that AdamW amplifies move by up to 4.2e-5, past PHI_ATOL.
    Returns per case the (steps, 4) losses, partner tables, final φ and θ,
    weight std and pool stats, and the initial ``params``.  ``resumed_only``: every case resumes a
    checkpoint, so the initial weights are drawn in a jit (faster; they
    are replaced).  ``params`` (numpy, JAX's layout): start every case from
    these weights instead (:func:`jax_params`, drawn before the port ran).
    ``data`` × ``model``: the mesh (``make_test_mesh(data, model, pod=pod)``,
    ``pod`` × ``data`` × ``model`` with a ``pod``) and ``plan`` its plan; a
    case's ``method`` ``fsdp`` is the CLI's baseline (the gradients
    all-reduced every step, no outer step).  A case's ``arch`` trains that
    registry arch's ``reduced()`` config from the case's ``params``
    (:func:`port_params`).  The run starts in a subprocess
    (:func:`start_script`) and this returns at once."""
    devices = data * (pod or 1) * max([model] + [c.get("model", model) for _, c in cases])
    return start_script(JAX_SCRIPT, {"tiny": TINY, "run": RUN, "cases": cases,
                                     "resumed_only": resumed_only, "params": params,
                                     "data": data, "model": model, "pod": pod, "plan": plan},
                        tmp, devices, fast_compile=fast_compile)


def jax_params():
    """JAX's initial weights of TINY as :func:`jax_reference` draws them
    (from ``PRNGKey(0)``), drawn in this process in a jit (the same values
    as the eager draw, in half the time), as numpy: a run of the port can
    start from them before the reference runs."""
    import jax
    from repro.models import model as JM
    from repro.models.common import values_of
    from repro.models.config import ModelConfig as JModelConfig

    draw = jax.jit(JM.init_params, static_argnums=1)
    return jax.tree.map(np.asarray, values_of(draw(jax.random.PRNGKey(0), JModelConfig(**TINY))))


def port_params(cfg=None):
    """The port's initial weights of ``cfg`` (TINY by default), drawn from
    seed 0, as numpy: the port's trees have JAX's layout, so both packages
    can start from them with no JAX in this process, and the reference run
    can go on while the port's ranks run."""
    from repro_torch.models import model as model_api
    from repro_torch.models.config import ModelConfig
    from repro_torch.tree import tree_map

    cfg = cfg or ModelConfig(**TINY)
    return tree_map(lambda t: t.numpy(), model_api.init_params(torch.Generator().manual_seed(0),
                                                               cfg))


def delta_nbytes() -> int:
    """Bytes of one replica's Δ on TINY (fp32 throughout), counted from the
    parameter shapes."""
    from repro_torch.comm import bytes_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.tree import tree_leaves

    return sum(4 * int(np.prod(x.shape))
               for x in tree_leaves(bytes_model.abstract_params(ModelConfig(**TINY))))


def arch_config(arch: str):
    """The port's ``reduced()`` config of a registry arch in fp32, as the
    JAX reference run builds it."""
    from repro_torch.configs import registry

    return registry.get_config(arch).reduced(dtype="float32", remat=False)


def port_args(**case) -> argparse.Namespace:
    """The port CLI's flags for one TINY case on the CPU."""
    from repro_torch.launch import train_distributed

    argv = ["--device", "cpu", "--backend", "gloo", "--data", str(case.get("data", WORLD)),
            "--model", str(case.get("model", 1)),
            "--steps", str(case.get("steps", RUN["steps"])),
            "--inner-steps", str(case.get("inner_steps", RUN["inner_steps"])),
            "--batch-per-replica", str(RUN["batch_per_replica"]), "--seq", str(RUN["seq"]),
            "--lr", str(RUN["lr"]), "--pairing-pool", str(case.get("pairing_pool",
                                                                      RUN["pairing_pool"])),
            "--method", case.get("method", "noloco"), "--codec", case.get("codec", "none"),
            "--schedule", case.get("schedule", "random")]
    if case.get("ckpt_dir"):
        argv += ["--ckpt-dir", case["ckpt_dir"], "--ckpt-every", str(case.get("ckpt_every", 0))]
    if case.get("resume"):
        argv.append("--resume")
    for key, flag in (("fault_plan", "--fault-plan"), ("stale", "--stale"),
                      ("streams", "--stream-count"), ("log_jsonl", "--log-jsonl")):
        if case.get(key) is not None:
            argv += [flag, str(case[key])]
    if case.get("overlap"):
        argv.append("--overlap")
    if case.get("reassign"):
        argv.append("--reassign-data")
    return train_distributed.build_parser().parse_args(argv)


# every cross-rank function but isend / irecv, which P2POp must receive
# unwrapped (a batch_isend_irecv counts once)
DIST_CALLS = ("batch_isend_irecv", "send", "recv", "all_reduce", "reduce", "all_gather",
              "all_gather_object", "gather", "gather_object", "scatter", "broadcast",
              "broadcast_object_list", "reduce_scatter", "all_to_all", "barrier")


def _count_dist_calls(counter: collections.Counter) -> None:
    """Wrap the cross-rank functions of ``torch.distributed`` in this
    process so that each call adds one to ``counter``."""
    import torch.distributed as dist

    for name in DIST_CALLS:
        fn = getattr(dist, name)

        @functools.wraps(fn)
        def counted(*a, __fn=fn, __name=name, **k):
            counter[__name] += 1
            return __fn(*a, **k)

        setattr(dist, name, counted)


def rank_runs(group, cases, params, root) -> dict:
    """Each case [(name, case dict)] on this rank, in turn, from the JAX
    initial weights ``params`` (None: the port's own, drawn from the seed):
    this rank's per-step losses, the partner
    tables, its final θ and φ rows, the weight std, pool stats and the
    ``torch.distributed`` calls made inside inner steps and inside outer
    steps (``calls``).  A case with ``fsdp`` > 1 runs the ``fsdp_hybrid``
    plan over ``data`` pods of ``fsdp × model`` ranks (the trainer API:
    no flag selects it); a case with an ``arch`` trains that arch's
    ``reduced()`` config from its own ``params`` (numpy, JAX's layout)."""
    from repro_torch.launch import train_distributed
    from repro_torch.models import convert
    from repro_torch.models.config import ModelConfig
    from repro_torch.parallel import plans
    from repro_torch.tree import tree_map

    counter = collections.Counter()
    _count_dist_calls(counter)
    out = {}
    for name, case in cases:
        case = dict(case)
        cfg = ModelConfig(**TINY) if case.get("arch") is None else arch_config(case["arch"])
        case_params = case.pop("params", params)
        for key in ("ckpt_dir", "log_jsonl"):
            if case.get(key):
                case[key] = os.path.join(root, case[key])
        if case.get("log_jsonl") and group.rank:
            case["log_jsonl"] = None
        if case.get("events") is not None:   # each rank reads its own copy of the plan
            case["fault_plan"] = os.path.join(root, f"plan-{name}-{group.rank}.json")
            with open(case["fault_plan"], "w") as f:
                json.dump({"events": case["events"]}, f)
        args = port_args(**case)
        plan = None
        if case.get("fsdp", 1) > 1:
            plan = plans.make_plan("fsdp_hybrid", case["fsdp"], case.get("model", 1),
                                   pod=case.get("data", WORLD))
        trainer = train_distributed.make_trainer(args, group, cfg, plan=plan)
        if case_params is not None:
            trainer.initial_params = lambda: convert.params_from_jax_numpy(case_params, cfg)
        calls = {"inner": collections.Counter(), "outer": collections.Counter(),
                 "outer_steps": 0, "syncs": []}

        def counted(kind, fn):
            def run(*a, **k):
                before = collections.Counter(counter)
                sent = collections.Counter(group.sent_bytes)
                res = fn(*a, **k)
                calls[kind].update(counter - before)
                if kind == "outer" and res[1]:
                    calls["outer_steps"] += 1
                    # each sync's bytes by kind, its stream record and the
                    # table its pre-send went along
                    sync = {"sent": dict(collections.Counter(group.sent_bytes) - sent)}
                    if trainer.stream_events:
                        sync["event"] = dict(trainer.stream_events[-1])
                        if trainer.comm_cfg.overlap:
                            sync["pre_partner"] = trainer.pre_partner(
                                sync["event"]["stream"]).tolist()
                    calls["syncs"].append(sync)
                return res
            return run

        trainer.inner_step = counted("inner", trainer.inner_step)
        trainer.maybe_outer_step = counted("outer", trainer.maybe_outer_step)
        trainer.outer_step_async = counted("outer", trainer.outer_step_async)
        warm = trainer.warm_start

        def warm_start(*a, **k):
            before = collections.Counter(counter)
            res = warm(*a, **k)
            calls["warm"].append(dict(counter - before))
            return res

        trainer.warm_start = warm_start
        calls["warm"] = []
        run = train_distributed.run_rank(group, args, trainer=trainer)
        res, sim = run["result"], run["sim"]
        state = res["state"]
        # whole replicas: with a model axis the shards are gathered (a
        # collective every rank makes, in this order)
        host = lambda t: tree_map(lambda x: x[0].detach().numpy().copy(), trainer.gather(t))
        out[name] = {"losses": res["losses"], "start_step": res["start_step"],
                     "partners": [p.tolist() for p in trainer.partners],
                     "theta": host(state["theta"]), "phi": host(state["phi"]),
                     "delta": host(state["delta"]), "mu": host(state["opt"].mu),
                     "nu": host(state["opt"].nu),
                     "count": state["opt"].count.tolist(), "outer_step": state["outer_step"],
                     "wstd": res["final_weight_std"], "pool": trainer.pool.stats(),
                     "calls": calls, "sent_bytes": dict(group.sent_bytes),
                     "comm_bytes": res["comm_bytes"], "comm": res["comm"],
                     "rounds": None if sim is None else sim.rounds(),
                     "summary": {k: res.get(k) for k in (
                         "max_staleness", "blocked_syncs", "recompiles", "blocking_bytes",
                         "outer_syncs")}}
        group.sent_bytes.clear()
    return out


def spawn_port(cases, params, root, *, data=WORLD, model=1, fsdp=1) -> list[dict]:
    """:func:`rank_runs` on ``data × fsdp × model`` gloo CPU ranks (``fsdp
    × model`` a replica), one intra-op thread each."""
    from repro_torch.launch import mesh

    return mesh.spawn(rank_runs, data * fsdp * model, (cases, params, root), backend="gloo",
                      device="cpu", threads=1, tp=model, fsdp=fsdp)


def rows(ranks, name, key, model=1):
    """Stack the ranks' ``key`` of case ``name`` along a leading axis: the
    stacked (R, ...) view of per-rank leaves (one rank a replica: its model
    index 0)."""
    from repro_torch.tree import tree_map

    parts = [r[name][key] for r in ranks[::model]]
    return tree_map(lambda *xs: np.stack(xs), *parts)


def losses(ranks, name, model=1) -> np.ndarray:
    """(steps, R) per-step losses of every replica."""
    return np.stack([np.asarray(r[name]["losses"]) for r in ranks[::model]], axis=1)


def leaves(tree) -> list:
    from repro_torch.tree import tree_leaves

    return [np.asarray(x) for x in tree_leaves(tree)]


def assert_phi_close(got, want, codec="none", atol=PHI_ATOL):
    """φ leaves within ``atol`` (PHI_ATOL; CHURN_PHI_ATOL for runs through
    churn); on the int8 wire within INT8_NEAR but for a share INT8_MOVED of
    the values, each within INT8_PHI_ATOL."""
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    if codec != "int8":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        return
    diff = np.concatenate([np.abs(g - w).reshape(-1) for g, w in zip(got, want)])
    assert diff.max() <= INT8_PHI_ATOL, diff.max()
    assert (diff > INT8_NEAR).mean() <= INT8_MOVED, (diff > INT8_NEAR).sum()


def torch_threads_one():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n


def stacked_run(params, events, *, steps, inner_steps, stale="naive", streams=1,
                overlap=None, codec="none"):
    """The port's stacked ``GossipProgram`` under ``SimCluster`` with the
    plan ``events`` (None: no plan), descending the mean of the replicas'
    losses as the ranks do, from ``params`` (JAX's): every step's
    (R,) losses times the world, NaN where a replica sat the step out,
    the partner tables, the round records and the final state."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import OuterConfig, TrainerConfig
    from repro_torch.data import LoaderConfig, shard_iterator
    from repro_torch.models import convert
    from repro_torch.models import model as model_api
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.sim import FaultPlan, SimCluster
    from repro_torch.train import adapters

    threads = torch_threads_one()
    cfg = ModelConfig(**TINY)
    tcfg = TrainerConfig(
        outer=OuterConfig(method="noloco", alpha=0.5, beta=0.7, inner_steps=inner_steps,
                          stale=stale),
        inner=AdamWConfig(lr=RUN["lr"], weight_decay=0.0),
        comm=CommConfig(codec=codec, streams=streams,
                        overlap=streams > 1 if overlap is None else overlap))
    program = adapters.GossipProgram(cfg, tcfg, replicas=WORLD, device="cpu")
    init = convert.params_from_jax_numpy(params, cfg)
    program.initial_params = lambda: init
    program.trainer.loss_fn = lambda p, b: model_api.stacked_loss(p, cfg, b) / WORLD
    sim = program if events is None else SimCluster(program, FaultPlan.build(events))
    loader = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=RUN["seq"],
                                         per_replica_batch=RUN["batch_per_replica"],
                                         replicas=WORLD))
    masks = []   # the active mask each inner step ran with (after the step's events)
    real_inner = program.inner_step

    def inner_step(state, batch):
        masks.append(program.elastic.active_array())
        return real_inner(state, batch)

    program.inner_step = inner_step
    state = sim.init_state(None)
    losses = []
    try:
        for _ in range(steps):
            state, metrics = sim.inner_step(state, next(loader))
            mask = masks[-1]
            # the program reports its members' losses, a member the clock
            # froze included (its loss is computed and not descended)
            row = np.full((WORLD,), np.nan, dtype=np.float32)
            row[list(program.elastic.active_ids())] = (metrics["loss"] * WORLD).numpy()
            if mask is not None:
                row[~mask] = np.nan
            losses.append(row)
            state, _ = sim.maybe_outer_step(state)
    finally:
        torch.set_num_threads(threads)
    return {"losses": np.stack(losses), "partners": [p.tolist() for p in program.partners],
            "rounds": None if events is None else sim.rounds(), "state": state}
