"""The port's serving slice against the JAX package's, on the CPU.

Weights come from the JAX initialiser and are converted with
``repro_torch.models.convert``, so both packages compute the same function.
Model-level logits agree within 1e-3 in fp32 (matmuls sum in another
order); greedy engine tokens agree exactly.  Sampled tokens are held
against the JAX engine's in ``tests/test_torch_sampling.py``; here, within
the port, a sampled request gets the same tokens batched as alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.models.attention import PagedView as JaxView
from repro.models.common import values_of
from repro.parallel.sharding import ShardCtx
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import registry
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.attention import PagedView
from repro_torch.serve import BlockAllocator, Request, ServeConfig, ServeEngine

CTX = ShardCtx.local()
ARCHS = ["qwen3-0.6b", "paper-small-125m"]
LOGIT_ATOL = 1e-3


def _configs(arch):
    jcfg = jax_registry.get_config(arch).reduced(dtype="float32", remat=False)
    cfg = registry.get_config(arch).reduced(dtype="float32", remat=False)
    return jcfg, cfg


def _jax_numpy_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(seed), jcfg)))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return None if tree is None else tuple(tree.shape)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# ---------------------------------------------------------------------------
# (a) parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips_jax_params(arch):
    jcfg, cfg = _configs(arch)
    tree = _jax_numpy_params(jcfg)
    params = convert.params_from_jax_numpy(tree, cfg, "cpu", torch.float32)
    assert _shapes(params) == _shapes(tree)
    for got, want in zip(_leaves(params), _leaves(tree), strict=True):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    bad = dict(tree, embed={"table": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax_numpy(bad, cfg)


def test_convert_keeps_bf16_bits():
    jcfg, cfg = _configs("qwen3-0.6b")
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, cfg))
    tree = _jax_numpy_params(jcfg)
    params = convert.params_from_jax_numpy(tree, cfg)
    w = params["stack"]["scan"][0]["attn"]["w_q"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), tree["stack"]["scan"][0]["attn"]["w_q"].astype(np.float32))
    assert params["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS + ["paper-medium-1.3b"])
def test_init_params_matches_jax_structure(arch):
    jcfg, cfg = _configs(arch)
    jax_shapes = _shapes(jax.eval_shape(lambda: values_of(JM.init_params(jax.random.PRNGKey(0), jcfg))))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    assert _shapes(params) == jax_shapes
    assert convert.expected_shapes(cfg) == jax_shapes
    # same standard deviations as the JAX initialiser (truncated at 2σ)
    w = params["stack"]["scan"][0]["attn"]["w_q"]
    assert abs(w.std().item() * np.sqrt(cfg.d_model) - 0.88) < 0.05
    assert w.abs().max().item() <= 2.0 / np.sqrt(cfg.d_model) + 1e-6


def test_other_archs_name_their_roadmap_item():
    """whisper-base resolves since ROADMAP item 8d; paged serving refuses it
    with the reference's ValueError (its prompts are no plain token
    streams), and the dense cache serves it (tests/test_torch_encdec.py)."""
    jcfg = jax_registry.get_config("whisper-base").reduced(dtype="float32", remat=False)
    cfg = registry.get_config("whisper-base").reduced(dtype="float32", remat=False)
    with pytest.raises(ValueError) as want:
        JM.init_paged_cache_tree(jcfg, 1, 4, 4)
    with pytest.raises(ValueError) as got:
        M.init_paged_cache_tree(cfg, 1, 4, 4)
    assert str(got.value) == str(want.value)
    assert "paged serving supports decoder-only token models" in str(got.value)


def test_paged_cache_tree_rejects_encdec():
    _, cfg = _configs("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, arch_type="encdec", is_encoder_decoder=True,
                              num_encoder_layers=1, encoder_seq=8)
    with pytest.raises(ValueError, match="paged"):
        M.init_paged_cache_tree(cfg, 1, 4, 4)


# ---------------------------------------------------------------------------
# (b) model-level logits: one ragged prefill chunk, then decode steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_logits_match_jax(arch):
    jcfg, cfg = _configs(arch)
    tree = _jax_numpy_params(jcfg, seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = convert.params_from_jax_numpy(tree, cfg)

    num_pages, page_size, chunk = 12, 4, 8
    rng = np.random.default_rng(0)
    tables = np.full((3, num_pages), num_pages, np.int32)      # trash-filled
    tables[0, :4] = [5, 0, 9, 2]
    tables[1, :4] = [1, 7, 3, 11]
    tables[1, 4:6] = [5, 0]                                     # stale ids
    active = np.array([True, True, False])
    lengths = np.array([7, 5, 0], np.int32)                     # slot 0: 7 of 8
    tokens = rng.integers(0, cfg.vocab_size, size=(3, chunk)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(6, 3, 1)).astype(np.int32)

    jcaches = JM.init_paged_cache_tree(jcfg, 3, num_pages, page_size)
    caches = M.init_paged_cache_tree(cfg, 3, num_pages, page_size)

    def views(pos):
        return (JaxView(jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(active)),
                PagedView(torch.from_numpy(tables), torch.from_numpy(pos), torch.from_numpy(active)))

    jv, tv = views(np.zeros(3, np.int32))
    want, jcaches = JM.paged_prefill_chunk(
        jparams, jcfg, jnp.asarray(tokens), jcaches, jv, CTX, lengths=jnp.asarray(lengths))
    got, caches = M.paged_prefill_chunk(
        params, cfg, torch.from_numpy(tokens), caches, tv, lengths=torch.from_numpy(lengths))
    assert got.shape == (3, 1, cfg.vocab_size) and got.dtype == torch.float32
    errs = [np.abs(got.numpy()[active] - np.asarray(want)[active]).max()]

    pos = lengths.copy()
    for toks in steps:
        jv, tv = views(pos)
        want, jcaches = JM.paged_decode_step(jparams, jcfg, jnp.asarray(toks), jcaches, jv, CTX)
        got, caches = M.paged_decode_step(params, cfg, torch.from_numpy(toks), caches, tv)
        errs.append(np.abs(got.numpy()[active] - np.asarray(want)[active]).max())
        pos = pos + active
    assert max(errs) <= LOGIT_ATOL, errs


# ---------------------------------------------------------------------------
# (c) engine tokens: the port's engine against the JAX engine
# ---------------------------------------------------------------------------


MIX = [(3, 6, 0.0), (11, 4, 0.0), (5, 8, 0.0), (9, 5, 0.0)]


def _requests(vocab, mix, cls=Request, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(0, vocab, size=(pl,))],
                max_new=gl, temperature=t)
            for i, (pl, gl, t) in enumerate(mix)]


def test_engine_greedy_tokens_match_jax():
    jcfg, cfg = _configs("qwen3-0.6b")
    tree = _jax_numpy_params(jcfg, seed=2)
    kw = dict(max_slots=2, num_pages=24, page_size=4, max_new_cap=8, prefill_chunk=4)
    jax_done = JaxEngine(jax.tree.map(jnp.asarray, tree), jcfg, JaxServeConfig(**kw)).run(
        _requests(cfg.vocab_size, MIX, JaxRequest))
    engine = ServeEngine(convert.params_from_jax_numpy(tree, cfg), cfg, ServeConfig(**kw))
    done = engine.run(_requests(cfg.vocab_size, MIX))
    assert sorted(f.rid for f in done) == [0, 1, 2, 3]
    want = {f.rid: f.tokens for f in jax_done}
    for f in done:
        assert len(f.tokens) == MIX[f.rid][1]
        assert f.tokens == want[f.rid], f"rid {f.rid}"
    engine.alloc.check_leaks()


# ---------------------------------------------------------------------------
# (d) inside the port: batched == solo, greedy and sampled
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temps,budget", [((0.0,), 0), ((0.7,), 0), ((0.0, 0.7), 4)],
                         ids=["greedy", "sampled", "mixed-budget"])
def test_batched_equals_solo(temps, budget):
    _, cfg = _configs("qwen3-0.6b")
    params = M.init_params(torch.Generator().manual_seed(3), cfg)
    scfg = ServeConfig(max_slots=2, num_pages=24, page_size=4, max_new_cap=8,
                       prefill_chunk=4, prefill_budget=budget)
    mix = [(pl, gl, temps[i % len(temps)]) for i, (pl, gl, _) in enumerate(MIX)]
    requests = _requests(cfg.vocab_size, mix, seed=1)
    streamed: dict[int, list[int]] = {}

    def token_cb(rid, index, token, t):
        assert index == len(streamed.setdefault(rid, []))
        streamed[rid].append(token)

    batched = {f.rid: f.tokens for f in ServeEngine(params, cfg, scfg).run(
        [dataclasses.replace(r) for r in requests], token_cb=token_cb, drain_every=2)}
    assert streamed == batched
    for r in requests:
        [solo] = ServeEngine(params, cfg, scfg).run([dataclasses.replace(r)])
        assert solo.tokens == batched[r.rid], f"rid {r.rid}"
    if 0.7 in temps:  # sampling really draws: a hot request leaves the greedy path
        greedy = ServeEngine(params, cfg, scfg).run(
            [dataclasses.replace(r, temperature=0.0) for r in requests])
        assert any(f.tokens != batched[f.rid] for f in greedy)


def test_continuous_needs_fewer_decode_steps_than_static():
    _, cfg = _configs("qwen3-0.6b")
    params = M.init_params(torch.Generator().manual_seed(4), cfg)
    requests = _requests(cfg.vocab_size, [(3, 8, 0.0), (5, 2, 0.0), (4, 2, 0.0), (6, 8, 0.0)])
    steps = {}
    for policy in ("continuous", "static"):
        scfg = ServeConfig(max_slots=2, num_pages=24, page_size=4, max_new_cap=8, policy=policy)
        engine = ServeEngine(params, cfg, scfg)
        assert len(engine.run([dataclasses.replace(r) for r in requests])) == 4
        steps[policy] = engine.decode_steps
    assert steps["continuous"] < steps["static"], steps


def test_single_shot_prefill_waits_for_flash_attention(monkeypatch):
    """``prefill_chunk=0`` admits each prompt whole through the flash op
    (one call per attention layer per request, no paged chunk op) and
    gives the chunked engine's tokens, greedy and sampled."""
    from repro_torch.models import attention

    _, cfg = _configs("qwen3-0.6b")
    params = M.init_params(torch.Generator().manual_seed(4), cfg)
    requests = _requests(cfg.vocab_size, [(3, 4, 0.0), (9, 3, 0.7), (1, 5, 0.0)])
    scfg = ServeConfig(max_slots=2, num_pages=24, page_size=4, max_new_cap=8)
    chunked = {f.rid: f.tokens for f in ServeEngine(params, cfg, scfg).run(
        [dataclasses.replace(r) for r in requests])}
    calls = {"flash_attention": 0, "paged_chunk_attention": 0}
    for name in calls:
        real = getattr(attention.kernel_ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(attention.kernel_ops, name, counted)
    engine = ServeEngine(params, cfg, dataclasses.replace(scfg, prefill_chunk=0))
    whole = {f.rid: f.tokens for f in engine.run([dataclasses.replace(r) for r in requests])}
    assert whole == chunked
    assert calls == {"flash_attention": cfg.num_layers * len(requests), "paged_chunk_attention": 0}
    engine.alloc.check_leaks()


# ---------------------------------------------------------------------------
# (e) block allocator
# ---------------------------------------------------------------------------


def test_block_allocator():
    al = BlockAllocator(num_pages=8, page_size=4)
    assert al.trash_page == 8
    assert al.blocks_for(1) == 1 and al.blocks_for(4) == 1 and al.blocks_for(5) == 2
    a = al.alloc(3)
    b = al.alloc(5)
    assert len(set(a) | set(b)) == 8 and al.free_count == 0
    assert not al.can_alloc(1)
    with pytest.raises(MemoryError):
        al.alloc(1)
    al.free(b)
    assert al.free_count == 5
    with pytest.raises(ValueError, match="double free"):
        al.free([b[0]])
    with pytest.raises(ValueError, match="invalid"):
        al.free([al.trash_page])
    al.free(a)
    assert al.free_count == 8


def test_lease_reserve_commit_rollback():
    al = BlockAllocator(num_pages=6, page_size=4)
    lease = al.reserve(2)
    al.check_leaks()
    kept = al.commit(lease)
    al.check_leaks(owned=2)
    with pytest.raises(ValueError, match="commit of committed"):
        al.commit(lease)
    other = al.reserve(3)
    al.rollback(other)
    al.check_leaks(owned=2)
    al.free(kept)
    al.check_leaks()


# ---------------------------------------------------------------------------
# (e) train → serve promotion
# ---------------------------------------------------------------------------


def _gossip_checkpoint(path, jcfg, mask=(True, True, True, True), step=7):
    """A JAX-written gossip checkpoint of the reduced model: 4 replicas whose
    θ and φ differ, the given membership mask."""
    from repro.checkpoint import ckpt as jckpt

    rng = np.random.default_rng(5)
    one = _jax_numpy_params(jcfg)
    noise = lambda x, s: (x[None] + s * rng.normal(size=(4,) + x.shape)).astype(x.dtype)
    tree = {"program": {
        "theta": jax.tree.map(lambda x: noise(x, 0.02), one),
        "outer": {"phi": jax.tree.map(lambda x: noise(x, 0.02), one),
                  "delta": jax.tree.map(lambda x: noise(0 * x, 0.01), one), "step": np.int32(3)},
        "inner_step": np.int32(step),
        "membership": {"mask": np.array(mask), "epoch": np.int64(0 if all(mask) else 1),
                       "partition": np.full(4, -1, np.int64)},
    }, "loop": {"step": np.int64(step)}}
    jckpt.save(str(path), step, tree)


@pytest.mark.parametrize("replica,source", [(2, "theta"), (1, "phi"), (9, "phi")],
                         ids=["theta", "frozen-phi", "out-of-range"])
def test_promote_matches_jax(tmp_path, replica, source):
    """Same weights, info and warnings as the JAX package's promote; replica
    1 is frozen in the saved membership and falls back to replica 0."""
    import warnings

    from repro.serve.promote import promote as jax_promote
    from repro_torch.serve import promote

    jcfg, cfg = _configs("paper-small-125m")
    _gossip_checkpoint(tmp_path, jcfg, mask=(True, False, True, True))
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want, want_info = jax_promote(str(tmp_path), replica=replica, source=source)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got, info = promote(str(tmp_path), cfg, replica=replica, source=source, device="cpu")
    assert info == want_info and info["replica"] == (2 if replica == 2 else 0)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    assert len(pw) == (replica != 2)
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_promote_rejects_what_cannot_be_served(tmp_path):
    from repro.checkpoint import ckpt as jckpt
    from repro_torch.serve import promote, resolve_replica

    _, cfg = _configs("paper-small-125m")
    jckpt.save(str(tmp_path / "pipe"), 1, {"program": {"params": [np.zeros(2)]}})
    with pytest.raises(ValueError, match="pipeline"):
        promote(str(tmp_path / "pipe"), cfg, device="cpu")
    jckpt.save(str(tmp_path / "odd"), 1, {"program": {"weights": np.zeros(2)}})
    with pytest.raises(ValueError, match="unrecognized checkpoint layout"):
        promote(str(tmp_path / "odd"), cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        promote(str(tmp_path / "none"), cfg, device="cpu")
    with pytest.raises(ValueError, match="source"):
        promote(str(tmp_path / "odd"), cfg, source="delta", device="cpu")
    assert resolve_replica(None, 3, 4) == 3


def test_promote_rejects_a_pipeline_program_checkpoint(tmp_path):
    """A checkpoint the port's routed pipeline wrote (TINY, 2 stages, 2
    steps) is refused with the reference's message."""
    from repro.serve.promote import promote as jax_promote
    from repro_torch.core.outer import OuterConfig
    from repro_torch.data import LoaderConfig
    from repro_torch.models.config import ModelConfig
    from repro_torch.pipeline import PipelineTrainer
    from repro_torch.serve import promote
    from repro_torch.train import LoopConfig, PipelineProgram, make_loop

    cfg = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=128, dtype="float32", remat=False)
    tr = PipelineTrainer(cfg, num_stages=2, replicas=4, device="cpu",
                         outer=OuterConfig(method="noloco", inner_steps=2))
    make_loop(PipelineProgram(tr), LoaderConfig(vocab_size=128, seq_len=16, per_replica_batch=2,
                                                replicas=4),
              LoopConfig(steps=2, ckpt_dir=str(tmp_path))).run()
    with pytest.raises(ValueError, match="pipeline") as want:
        jax_promote(str(tmp_path))
    with pytest.raises(ValueError, match="pipeline") as got:
        promote(str(tmp_path), cfg, device="cpu")
    assert str(got.value) == str(want.value)


def test_serve_cli_promoted_tokens_match_jax_cli(tmp_path, monkeypatch, capsys):
    """``--ckpt D --replica 1 --weights phi`` on the reduced model: the port's
    CLI on the CPU gives the JAX serve CLI's greedy tokens; a checkpoint
    that does not fit the config names both."""
    import json
    import sys

    from repro.launch import serve as jax_serve_cli
    from repro_torch.launch import serve as serve_cli

    jcfg, _ = _configs("paper-small-125m")
    _gossip_checkpoint(tmp_path / "ck", jcfg)
    args = ["--arch", "paper-small-125m", "--ckpt", str(tmp_path / "ck"), "--replica", "1",
            "--weights", "phi", "--requests", "3", "--prompt-lens", "5,11", "--gen-lens", "4,6",
            "--pages", "32", "--page-size", "4", "--prefill-chunk", "4"]
    logs = {name: tmp_path / f"{name}.jsonl" for name in ("jax", "port")}
    monkeypatch.setattr(sys, "argv", ["serve", *args, "--log-jsonl", str(logs["jax"])])
    jax_serve_cli.main()
    jax_summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    summary = serve_cli.main([*args, "--device", "cpu", "--log-jsonl", str(logs["port"])])
    assert summary["promoted"] == jax_summary["promoted"] == {
        "step": 7, "replica": 1, "source": "phi", "world": 4}

    def tokens(path):
        return {e["rid"]: e["tokens"] for e in map(json.loads, open(path)) if e["event"] == "finish"}

    assert tokens(logs["port"]) == tokens(logs["jax"]) and len(tokens(logs["port"])) == 3
    with pytest.raises(ValueError, match=r"does not fit paper-small-125m with 12 layers of "
                                         r"d_model 768.*shape \(512, 256\) != expected \(128000, 768\)"):
        serve_cli.main([*args, "--device", "cpu", "--full"])
