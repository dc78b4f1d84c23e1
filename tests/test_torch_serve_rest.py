"""Single-shot paged prefill and the speculative verify pass of the port
against the JAX package's, on the CPU, on the "global", "rglru" and "ssd"
configs of ``tests/test_serve_fast.py``.

Weights come from the JAX initialiser and are converted with
``repro_torch.models.convert``, so both packages compute the same function.
Tolerances (fp32): logits within LOGIT_ATOL 1e-3 of JAX's, as the other
serving files (matmuls and scans sum in another order); recurrent states
and page pools within STATE_ATOL 1e-4.  The verify's logits equal the
port's own decode steps within VERIFY_ATOL 1e-5: its projections run over
R·C rows where a decode step's run over R, and a CPU GEMM may sum a row in
another order with M (measured: up to 1.2e-6).  Engine tokens are held
exactly: single-shot against the JAX single-shot engine and against the
port's chunked engine, greedy and at temperature 0.7.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.attention import PagedAttnCache as JaxPagedCache
from repro.models.attention import PagedView as JaxView
from repro.models.common import values_of
from repro.models.config import ModelConfig as JaxModelConfig
from repro.parallel.sharding import ShardCtx
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxEngine
from repro_torch.launch import serve as serve_cli
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.attention import PagedAttnCache, PagedView
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Request, ServeConfig, ServeEngine

CTX = ShardCtx.local()
LOGIT_ATOL = 1e-3
STATE_ATOL = 1e-4
VERIFY_ATOL = 1e-5
# the "global", "rglru" and "ssd" configs of tests/test_serve_fast.py
KW = {
    "global": dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=128, qk_norm=True, dtype="float32", remat=False),
    "rglru": dict(arch_type="hybrid", num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
                  d_ff=128, vocab_size=128, attn_pattern=("rglru", "rglru", "local"),
                  sliding_window=6, lru_width=64, dtype="float32", remat=False),
    "ssd": dict(arch_type="ssm", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=0,
                vocab_size=128, attn_pattern=("ssd",), ssm_state_dim=16, ssm_head_dim=32,
                ssm_chunk=4, use_rope=False, dtype="float32", remat=False),
}
KINDS = list(KW)


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one intra-op thread, leaving the cores to JAX."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(kind, seed=2):
    jcfg, cfg = JaxModelConfig(**KW[kind]), ModelConfig(**KW[kind])
    tree = jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(seed), jcfg)))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), convert.params_from_jax_numpy(tree, cfg)


def _entries(jcaches, caches):
    """(JAX entry, port entry, stacked) of every cache entry of both trees."""
    for part, stacked in (("scan", True), ("rem", False)):
        for je, e in zip(jcaches[part], caches[part], strict=True):
            if e is not None:
                yield je[0], e[0], stacked


def _fields(cache):
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


def _assert_caches_close(jcaches, caches, what):
    for jc, c, _ in _entries(jcaches, caches):
        for name, t in _fields(c).items():
            want = np.asarray(getattr(jc, name))
            if isinstance(c, PagedAttnCache):   # the trash page holds garbage
                want, t = want[:-1], t[:-1]
            np.testing.assert_allclose(t.numpy(), want, atol=STATE_ATOL, rtol=0,
                                       err_msg=f"{what} {type(c).__name__}.{name}")


# ---------------------------------------------------------------------------
# model level: single-shot prefill, the verify pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_paged_prefill_matches_jax(kind):
    """One 11-token prompt (past the local window of 6) in one call: the
    last logits, the K/V scattered into the slot's pages and the recurrent
    scratch states."""
    jcfg, cfg, jparams, params = _setup(kind, seed=1)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 11)).astype(np.int32)
    table = np.array([[2, 0, 5, 8, 8]], np.int32)   # pages 2, 0, 5; 8 is the trash page
    jcaches = JM.init_paged_cache_tree(jcfg, 1, 8, 4)
    jview = JaxView(jnp.asarray(table), jnp.zeros((1,), jnp.int32), jnp.ones((1,), bool))
    jlogits, jcaches = JM.paged_prefill(jparams, jcfg, jnp.asarray(toks), jcaches, jview, CTX)
    caches = M.init_paged_cache_tree(cfg, 1, 8, 4)
    view = PagedView(torch.from_numpy(table), torch.zeros(1, dtype=torch.int32),
                     torch.ones(1, dtype=torch.bool))
    logits, caches = M.paged_prefill(params, cfg, torch.from_numpy(toks), caches, view)
    assert logits.shape == (1, 1, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    _assert_caches_close(jcaches, caches, "single-shot")


def _two_slot_prefill(jcfg, cfg, jparams, params):
    """Both packages' caches after one chunked prefill of two slots
    (lengths 5 and 3), the tables and the prompt tokens."""
    tables = np.array([[0, 1, 2, 8], [3, 4, 5, 8]], np.int32)
    toks = np.array([[5, 9, 2, 7, 1], [3, 3, 8, 0, 0]], np.int32)
    lengths = np.array([5, 3], np.int32)
    jcaches = JM.init_paged_cache_tree(jcfg, 2, 8, 4)
    jview = JaxView(jnp.asarray(tables), jnp.zeros((2,), jnp.int32), jnp.ones((2,), bool))
    _, jcaches = JM.paged_prefill_chunk(jparams, jcfg, jnp.asarray(toks), jcaches, jview, CTX,
                                        lengths=jnp.asarray(lengths))
    caches = M.init_paged_cache_tree(cfg, 2, 8, 4)
    view = PagedView(torch.from_numpy(tables), torch.zeros(2, dtype=torch.int32),
                     torch.ones(2, dtype=torch.bool))
    M.paged_prefill_chunk(params, cfg, torch.from_numpy(toks), caches, view,
                          lengths=torch.from_numpy(lengths))
    return jcaches, caches, tables, lengths


def _clone(caches):
    return {part: [None if e is None else
                   (type(e[0])(**{k: t.clone() for k, t in _fields(e[0]).items()}), e[1])
                   for e in caches[part]] for part in caches}


@pytest.mark.parametrize("kind", KINDS)
def test_verify_logits_and_trajectories_match_jax(kind):
    """``paged_prefill_chunk(collect=True)`` after a two-slot prefill: C = 3
    fed tokens at positions 5 and 3, slot 1 with 2 real.  Logits of every
    real position and each recurrent layer's per-token trajectory against
    JAX's, the pools as JAX writes them, the port's recurrent rows left as
    they were, and each row against the port's own decode steps."""
    jcfg, cfg, jparams, params = _setup(kind)
    jcaches, caches, tables, lengths = _two_slot_prefill(jcfg, cfg, jparams, params)
    feed = np.array([[4, 6, 1], [2, 9, 5]], np.int32)
    base, vlen = lengths, np.array([3, 2], np.int32)
    jview = JaxView(jnp.asarray(tables), jnp.asarray(base), jnp.ones((2,), bool))
    jlogits, jtraj = JM.paged_prefill_chunk(jparams, jcfg, jnp.asarray(feed), jcaches, jview,
                                            CTX, lengths=jnp.asarray(vlen), collect=True)
    before = _clone(caches)
    view = PagedView(torch.from_numpy(tables), torch.from_numpy(base),
                     torch.ones(2, dtype=torch.bool))
    logits, traj = M.paged_prefill_chunk(params, cfg, torch.from_numpy(feed), caches, view,
                                         lengths=torch.from_numpy(vlen), collect=True)
    assert logits.shape == (2, 3, cfg.vocab_size) and logits.dtype == torch.float32
    jlogits = np.asarray(jlogits)
    for r in range(2):
        np.testing.assert_allclose(logits[r, :vlen[r]].numpy(), jlogits[r, :vlen[r]],
                                   atol=LOGIT_ATOL, rtol=0)
    n_rec = 0
    for jc, c, stacked in _entries(jtraj, traj):
        if isinstance(c, PagedAttnCache):
            assert isinstance(jc, JaxPagedCache)
            for name, t in _fields(c).items():
                np.testing.assert_allclose(t[:-1].numpy(), np.asarray(getattr(jc, name))[:-1],
                                           atol=STATE_ATOL, rtol=0)
            continue
        n_rec += 1
        for name, t in _fields(c).items():
            want = np.asarray(getattr(jc, name))
            assert tuple(t.shape) == want.shape, name    # (L?, R, C, ...)
            for r in range(2):   # slot r's real positions
                got_r = (t[:, r, :vlen[r]] if stacked else t[r, :vlen[r]]).numpy()
                want_r = want[:, r, :vlen[r]] if stacked else want[r, :vlen[r]]
                np.testing.assert_allclose(got_r, want_r, atol=STATE_ATOL, rtol=0,
                                           err_msg=f"{type(c).__name__}.{name} slot {r}")
    assert n_rec == {"global": 0, "rglru": 2, "ssd": 1}[kind]   # recurrent cache entries
    for (b, _, _), (a, _, _) in zip(_entries(before, before), _entries(caches, caches)):
        if not isinstance(a, PagedAttnCache):
            for name, t in _fields(a).items():
                assert torch.equal(t, _fields(b)[name]), f"verify wrote {name}"
    # each row as the decode step at base + c computes it
    rows = []
    for c in range(3):
        step_view = PagedView(torch.from_numpy(tables), torch.from_numpy(base + c),
                              torch.ones(2, dtype=torch.bool))
        lg, _ = M.paged_decode_step(params, cfg, torch.from_numpy(feed[:, c:c + 1]), before,
                                    step_view)
        rows.append(lg[:, 0])
    dec = torch.stack(rows, dim=1)
    for r in range(2):
        torch.testing.assert_close(logits[r, :vlen[r]], dec[r, :vlen[r]], atol=VERIFY_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the engine at prefill_chunk=0
# ---------------------------------------------------------------------------

# (prompt length, budget, temperature): a prompt of one token, a sampled one
# past the local window, and a third that waits for a free slot
LOAD = [(1, 4, 0.0), (11, 5, 0.7), (4, 6, 0.0)]


def _load(cls, vocab):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(0, vocab, size=(pl,))], max_new=gl,
                temperature=t) for i, (pl, gl, t) in enumerate(LOAD)]


@pytest.mark.parametrize("kind", KINDS)
def test_single_shot_engine_matches_jax_and_chunked(kind):
    jcfg, cfg, jparams, params = _setup(kind)
    kw = dict(max_slots=2, num_pages=24, page_size=4, max_new_cap=8, prefill_chunk=0)
    want = {f.rid: f.tokens for f in JaxEngine(jparams, jcfg, JaxServeConfig(**kw)).run(
        _load(JaxRequest, cfg.vocab_size))}
    engine = ServeEngine(params, cfg, ServeConfig(**kw))
    got = {f.rid: f.tokens for f in engine.run(_load(Request, cfg.vocab_size))}
    engine.alloc.check_leaks()
    assert got == want
    chunked = ServeEngine(params, cfg, ServeConfig(**dict(kw, prefill_chunk=3)))
    assert {f.rid: f.tokens for f in chunked.run(_load(Request, cfg.vocab_size))} == got


def test_single_shot_config_rules():
    ServeConfig(prefill_chunk=0).validate()
    with pytest.raises(ValueError, match="prefill_budget requires chunked"):
        ServeConfig(prefill_chunk=0, prefill_budget=4).validate()
    with pytest.raises(ValueError, match=">= 0"):
        ServeConfig(prefill_chunk=-1).validate()


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--requests", "3", "--max-batch", "2", "--pages", "32",
       "--page-size", "8", "--prompt-lens", "5,20", "--gen-lens", "6,4", "--temps", "0.0,0.7"]


def test_cli_single_shot_prefill_on_cpu():
    summary = serve_cli.main([*CLI, "--prefill-chunk", "0", "--verify"])
    assert summary["prefill_chunk"] == 0 and summary["parity"] is True
    assert summary["gen_tokens"] == 6 + 4 + 6 and "spec_k" not in summary


def test_cli_spec_decode_with_truncated_draft_on_cpu(tmp_path):
    log = tmp_path / "serve.jsonl"
    summary = serve_cli.main([*CLI, "--spec-decode", "--draft-layers", "1", "--verify",
                              "--log-jsonl", str(log)])
    assert summary["draft"] == {"kind": "truncated", "layers": 1}
    assert summary["parity"] is True and summary["verify_mismatches"] == 0
    assert summary["spec_k"] == 4 and summary["spec_rounds"] > 0
    assert 0.0 <= summary["accept_rate"] <= 1.0
    events = [json.loads(line) for line in log.read_text().splitlines()]
    finish = [e for e in events if e["event"] == "finish"]
    assert len(finish) == 3 and all("accept_rate" in e and "spec_rounds" in e for e in finish)
    assert events[0]["event"] == "run_start" and events[0]["spec_decode"] is True


def test_cli_draft_replica_needs_ckpt():
    with pytest.raises(SystemExit):
        serve_cli.main([*CLI, "--spec-decode", "--draft-replica", "2"])
