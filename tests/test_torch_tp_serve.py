"""The sequence-sharded prefill and decode steps at tp 2 on the CPU.

``parallel.steps.build_prefill_step`` / ``build_decode_step`` on four
``gloo`` CPU ranks (two replicas of two model ranks; each replica serves
its half of the batch) against ``tests/test_multidevice.py::
test_decode_sharded_matches_local``'s scenario run by JAX's
``build_decode_step`` on ``make_test_mesh(2, 2)`` (TINY, B 8, cache 32, two
decode calls from an empty cache; the decode plan's ``kv_shard_seq``: the
heads whole on every rank, each global layer's cache split by sequence,
the partial softmax combined over the model axis), and against the port's
unsharded ``model.decode_step``, within 2e-3.  A prompt prefilled through
``build_prefill_step`` (each rank writing its slice of the prompt's
positions) and then decoded matches JAX's unsharded ``prefill`` /
``decode_step``.  The ``reduced()`` mamba2-370m and recurrentgemma-9b (no
global attention: no ``kv_shard_seq``; split heads over a local ring cache,
channel-split recurrent states) match the port's unsharded steps.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_dist_helpers as H

B, CACHE, PROMPT = 8, 32, 8
ATOL = 2e-3
RECURRENT = ["mamba2-370m", "recurrentgemma-9b"]

JAX_SCRIPT = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    import jax.sharding as jsh
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as M
    from repro.models.common import unzip, values_of
    from repro.models.config import ModelConfig
    from repro.parallel import compat, plans as PL, steps as ST
    from repro.parallel.sharding import ShardCtx

    spec = pickle.load(open(sys.argv[1], "rb"))
    cfg = ModelConfig(**spec["tiny"])
    mesh = make_test_mesh(2, 2)
    B, CACHE, PROMPT = spec["B"], spec["cache"], spec["prompt"]
    plan_d = PL.make_plan("gossip_dp", mesh, shape_kind="decode", has_global_attention=True)
    assert plan_d.kv_shard_seq
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    stacked = ST.stack_replicas(params, plan_d.replicas)
    vals, _ = unzip(stacked)
    caches = M.init_cache_tree(cfg, B, CACHE)
    toks = jax.random.randint(jax.random.PRNGKey(3), (B, 1), 0, cfg.vocab_size)
    bspecs = ST.batch_pspecs(plan_d, {"tokens": toks})
    with compat.set_mesh(mesh):
        fn, (pspecs, cspecs) = ST.build_decode_step(cfg, plan_d, mesh, stacked, caches, bspecs)
        theta = jax.device_put(vals, PL.shardings(mesh, pspecs))
        cache_put = jax.device_put(values_of(caches), PL.shardings(mesh, cspecs))
        tok_sh = jsh.NamedSharding(mesh, bspecs["tokens"])
        idx_sh = jsh.NamedSharding(mesh, jsh.PartitionSpec())
        lg1, cache_put = fn(theta, cache_put, jax.device_put(toks, tok_sh),
                            jax.device_put(jnp.asarray(0, jnp.int32), idx_sh))
        lg2, cache_put = fn(theta, cache_put, jax.device_put(toks + 1, tok_sh),
                            jax.device_put(jnp.asarray(1, jnp.int32), idx_sh))
    # a prompt prefilled and decoded twice, unsharded (every replica the same)
    ctx = ShardCtx.local()
    prompt = jax.random.randint(jax.random.PRNGKey(4), (B, PROMPT), 0, cfg.vocab_size)
    c = values_of(M.init_cache_tree(cfg, B, CACHE))
    _, c = M.prefill(params_v := values_of(params), cfg, {"tokens": prompt}, c, ctx)
    p1, c = M.decode_step(params_v, cfg, toks, jnp.asarray(PROMPT), c, ctx)
    p2, c = M.decode_step(params_v, cfg, toks + 1, jnp.asarray(PROMPT + 1), c, ctx)
    host = lambda t: jax.tree.map(np.asarray, t)
    pickle.dump({"params": host(values_of(params)), "toks": np.asarray(toks),
                 "prompt": np.asarray(prompt), "lg1": np.asarray(lg1), "lg2": np.asarray(lg2),
                 "p1": np.asarray(p1), "p2": np.asarray(p2)}, open(sys.argv[2], "wb"))
''')


def _config(name):
    from repro_torch.configs import registry
    from repro_torch.models.config import ModelConfig

    if name == "tiny":
        return ModelConfig(**H.TINY)
    return registry.get_config(name).reduced(dtype="float32", remat=False)


def _serve(cfg, theta, plan, group, tokens, prompt):
    """(logits after decode 1, after decode 2) of this rank's replica rows
    on its shard ``theta``, gathered over the vocabulary; ``prompt`` None:
    from an empty cache."""
    from repro_torch.models import model as model_api
    from repro_torch.parallel import steps

    ctx = plan.ctx(group.model)
    caches = model_api.init_cache_tree(cfg, tokens.shape[0], CACHE, ctx=ctx)
    start = 0
    if prompt is not None:
        steps.build_prefill_step(cfg, plan, group)(theta, caches, {"tokens": prompt})
        start = prompt.shape[1]
    decode = steps.build_decode_step(cfg, plan, group)
    out = []
    for i in range(2):
        logits, caches = decode(theta, caches, tokens + i, start + i)
        out.append(steps.gather_logits(logits, cfg, plan, group).numpy())
    return out


def rank_serve(group, ref, recurrent_params) -> dict:
    from repro_torch.models import convert
    from repro_torch.parallel import plans, steps

    r, rows = group.replica, slice(group.replica * B // 2, (group.replica + 1) * B // 2)
    tokens = torch.from_numpy(ref["toks"][rows].astype(np.int64))
    prompt = torch.from_numpy(ref["prompt"][rows].astype(np.int64))
    cfg = _config("tiny")
    plan = plans.make_plan("gossip_dp", group.replicas, group.tp, shape_kind="decode")
    assert plan.kv_shard_seq
    theta = convert.shard_from_jax_numpy(ref["params"], cfg, plan, group.model_index)
    out = {"tiny": _serve(cfg, theta, plan, group, tokens, None),
           "tiny_prefill": _serve(cfg, theta, plan, group, tokens, prompt)}
    for name in RECURRENT:
        cfg = _config(name)
        plan = plans.make_plan("gossip_dp", group.replicas, group.tp, shape_kind="decode",
                               has_global_attention="global" in cfg.attn_pattern)
        g = torch.Generator().manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)[rows]
        pr = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=g)[rows]
        theta = steps.shard_params(recurrent_params[name], cfg, plan, group.model_index,
                                   stacked=False)
        out[name] = _serve(cfg, theta, plan, group, toks, pr)
    return {"replica": r, "out": out}


def unsharded(cfg, params, tokens, prompt):
    from repro_torch.models import model as model_api

    caches = model_api.init_cache_tree(cfg, tokens.shape[0], CACHE)
    start = 0
    if prompt is not None:
        model_api.prefill(params, cfg, {"tokens": prompt}, caches)
        start = prompt.shape[1]
    out = []
    with torch.no_grad():
        for i in range(2):
            logits, caches = model_api.decode_step(params, cfg, tokens + i, start + i, caches)
            out.append(logits.numpy())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import mesh
    from repro_torch.models import convert
    from repro_torch.models import model as model_api

    root = str(tmp_path_factory.mktemp("tp_serve"))
    spec, out = os.path.join(root, "spec.pkl"), os.path.join(root, "jax.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"tiny": H.TINY, "B": B, "cache": CACHE, "prompt": PROMPT}, f)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, spec, out], env=H.jax_env(4),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        ref = pickle.load(f)
    recurrent = {n: model_api.init_params(torch.Generator().manual_seed(0), _config(n))
                 for n in RECURRENT}
    ranks = mesh.spawn(rank_serve, 4, (ref, recurrent), backend="gloo", device="cpu",
                       threads=1, tp=2)
    threads = H.torch_threads_one()
    try:
        cfg = _config("tiny")
        params = convert.params_from_jax_numpy(ref["params"], cfg)
        toks = torch.from_numpy(ref["toks"].astype(np.int64))
        local = {"tiny": unsharded(cfg, params, toks, None),
                 "tiny_prefill": unsharded(cfg, params, toks,
                                           torch.from_numpy(ref["prompt"].astype(np.int64)))}
        for name in RECURRENT:
            cfg = _config(name)
            g = torch.Generator().manual_seed(5)
            t = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
            pr = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=g)
            local[name] = unsharded(cfg, recurrent[name], t, pr)
    finally:
        torch.set_num_threads(threads)
    return {"jax": ref, "port": ranks, "local": local}


def _rows(ranks, name, step):
    """(B, 1, V) logits of decode ``step``: each replica's rows, from its
    model index 0 (every model rank holds the same gathered logits)."""
    for a, b in zip(ranks[0::2], ranks[1::2]):
        np.testing.assert_array_equal(a["out"][name][step], b["out"][name][step])
    return np.concatenate([r["out"][name][step] for r in ranks[0::2]])


def test_decode_matches_the_reference_sharded_step(runs):
    got = _rows(runs["port"], "tiny", 1)
    np.testing.assert_allclose(got, runs["jax"]["lg2"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(_rows(runs["port"], "tiny", 0), runs["jax"]["lg1"], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["tiny", "tiny_prefill"] + RECURRENT)
def test_matches_the_unsharded_decode(runs, name):
    for step in (0, 1):
        np.testing.assert_allclose(_rows(runs["port"], name, step), runs["local"][name][step],
                                   rtol=0, atol=ATOL)


def test_prefill_then_decode_matches_the_reference(runs):
    for step, key in ((0, "p1"), (1, "p2")):
        np.testing.assert_allclose(_rows(runs["port"], "tiny_prefill", step), runs["jax"][key],
                                   rtol=0, atol=ATOL)
