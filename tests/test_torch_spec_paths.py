"""Speculative decoding, truncated drafts, single-shot prefill and the
router within the port: the rules that need no reference (the vacuous
``accept_rate``, the refusals, drafts as views of the target's weights,
the router's placement) on the CPU, and the kernel paths on the card.

The ``cuda`` tests serve the "global", "rglru" and "ssd" configs of
``tests/test_serve_fast.py`` in fp32 on the card: speculative tokens equal
the plain engine's there, single-shot tokens equal the chunked engine's,
and every kernel launches as often as the design says (a round: ``spec_k``
decode-kernel launches per attention or recurrent layer of the draft and
as many of the target's verify; single-shot prefill: one flash forward per
attention layer per request and no chunk kernel).  They skip without a
GPU; on the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_spec_paths.py

The file imports neither JAX nor the JAX package.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.models import model as M
from repro_torch.models.attention import PagedView
from repro_torch.models.config import ModelConfig
from repro_torch.serve import (
    ReplicaRouter,
    Request,
    ServeConfig,
    ServeEngine,
    SpecServeEngine,
    truncate_layers,
)
from repro_torch.tree import tree_leaves

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
SCFG = ServeConfig(max_slots=2, num_pages=24, page_size=4, max_new_cap=8, prefill_chunk=4)
# the decode-step kernel of each layer kind, and its prefill kernel
DECODE_KERNEL = {"global": "paged_attention", "local": "paged_attention",
                 "rglru": "rglru_decode", "ssd": "ssd_decode"}
CHUNK_KERNEL = {"global": "paged_chunk_attention", "local": "paged_chunk_attention",
                "rglru": "rglru_scan", "ssd": "ssd_chunk"}


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one intra-op thread: the configs are tiny, and the other
    test workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(kind, seed=2, device="cpu"):
    cfg = ModelConfig(**KW[kind])
    return M.init_params(torch.Generator(device=device).manual_seed(seed), cfg), cfg


def _load(vocab, mix=((3, 6, 0.0), (8, 5, 0.7), (5, 7, 0.0))):
    rng = np.random.default_rng(9)
    return [Request(rid=rid, prompt=rng.integers(0, vocab, size=(pl,)).tolist(), max_new=gl,
                    temperature=t) for rid, (pl, gl, t) in enumerate(mix)]


def _tokens(engine, requests):
    return {f.rid: f.tokens for f in engine.run([dataclasses.replace(r) for r in requests])}


# ---------------------------------------------------------------------------
# CPU: the rules
# ---------------------------------------------------------------------------


def test_accept_rate_vacuous_with_no_usable_proposal():
    """max_new = 1: every round has rem == 1, so no proposal is usable and
    the rate is 1.0, not NaN and not 0.0, on the engine and per request."""
    params, cfg = _params("global")
    requests = _load(cfg.vocab_size, ((3, 1, 0.0), (8, 1, 0.0)))
    engine = SpecServeEngine(params, cfg, SCFG, params, cfg, spec_k=3)
    done = {f.rid: f for f in engine.run([dataclasses.replace(r) for r in requests])}
    assert {r: f.tokens for r, f in done.items()} == _tokens(ServeEngine(params, cfg, SCFG),
                                                            requests)
    assert engine.spec_prop_total == 0 and engine.accept_rate == 1.0
    assert all(f.stats["accept_rate"] == 1.0 for f in done.values())
    engine.alloc.check_leaks()


def test_accept_rate_defined_before_any_round():
    params, cfg = _params("global")
    engine = SpecServeEngine(params, cfg, SCFG, params, cfg, spec_k=3)
    assert engine.run([]) == [] and engine.accept_rate == 1.0 and engine.spec_rounds == 0


def test_spec_k_one_is_plain_decode():
    params, cfg = _params("rglru")
    requests = _load(cfg.vocab_size)
    engine = SpecServeEngine(params, cfg, SCFG, *truncate_layers(params, cfg, 1), spec_k=1)
    plain = ServeEngine(params, cfg, SCFG)
    assert _tokens(engine, requests) == _tokens(plain, requests)
    assert engine.spec_rounds == engine.decode_steps == plain.decode_steps
    assert engine.spec_prop_total == 0


def test_spec_engine_refusals():
    params, cfg = _params("global")
    with pytest.raises(ValueError, match="prefill_chunk"):
        SpecServeEngine(params, cfg, dataclasses.replace(SCFG, prefill_chunk=0), params, cfg)
    with pytest.raises(ValueError, match="spec_k"):
        SpecServeEngine(params, cfg, SCFG, params, cfg, spec_k=0)
    other = dataclasses.replace(cfg, vocab_size=64)
    with pytest.raises(ValueError, match="vocabulary"):
        SpecServeEngine(params, cfg, SCFG, M.init_params(torch.Generator().manual_seed(0), other),
                        other)


@pytest.mark.parametrize("kind,keep", [("global", 1), ("global", 2), ("rglru", 1),
                                       ("rglru", 2), ("ssd", 1)])
def test_truncated_draft_is_a_view_of_the_target(kind, keep):
    params, cfg = _params(kind)
    dparams, dcfg = truncate_layers(params, cfg, keep)
    assert dcfg.num_layers == keep and dcfg.attn_pattern == cfg.attn_pattern
    p = len(cfg.attn_pattern)
    for s in dparams["stack"]["scan"]:
        if s is not None:
            assert {int(leaf.shape[0]) for leaf in tree_leaves(s)} == {keep // p}
    assert len(dparams["stack"]["rem"]) == keep % p
    assert dparams["embed"] is params["embed"]
    storages = {leaf.untyped_storage().data_ptr() for leaf in tree_leaves(params)}
    assert all(leaf.untyped_storage().data_ptr() in storages for leaf in tree_leaves(dparams))
    # a runnable draft: one single-shot prefill through its cache tree
    caches = M.init_paged_cache_tree(dcfg, 1, 4, 4)
    view = PagedView(torch.tensor([[0, 1, 2, 4]], dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool))
    logits, _ = M.paged_prefill(dparams, dcfg, torch.tensor([[5, 9, 2]], dtype=torch.int32),
                                caches, view)
    assert logits.shape == (1, 1, cfg.vocab_size) and torch.isfinite(logits).all()


def test_truncate_layers_rejects_bad_depth():
    params, cfg = _params("global")
    for n in (0, cfg.num_layers + 1):
        with pytest.raises(ValueError, match="num_layers"):
            truncate_layers(params, cfg, n)


def test_router_least_loaded_prefers_idle_engine():
    params, cfg = _params("global")
    router = ReplicaRouter([ServeEngine(params, cfg, SCFG) for _ in range(2)],
                           policy="least_loaded")
    assert router.submit(Request(rid=0, prompt=[1] * 9, max_new=8)) == 0
    assert router.submit(Request(rid=1, prompt=[2] * 3, max_new=2)) == 1   # engine 0 holds 17
    assert router.submit(Request(rid=2, prompt=[3] * 2, max_new=2)) == 1
    assert router.routed == [1, 2]
    while not router.idle:
        router.step()
    for eng in router.engines:
        eng._evict_finished()
        eng.alloc.check_leaks()


def test_router_refusals():
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([])
    params, cfg = _params("global")
    with pytest.raises(ValueError, match="policy"):
        ReplicaRouter([ServeEngine(params, cfg, SCFG)], policy="random")


# ---------------------------------------------------------------------------
# the card: the kernel paths
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _kinds(cfg):
    return [cfg.attn_pattern[i % len(cfg.attn_pattern)] for i in range(cfg.num_layers)]


def _per_kernel(cfg, table, n):
    out: dict[str, int] = {}
    for kind in _kinds(cfg):
        out[table[kind]] = out.get(table[kind], 0) + n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KW))
def test_spec_on_card_matches_plain_with_design_launches(kind, cuda):
    params, cfg = _params(kind, device=cuda)
    dparams, dcfg = truncate_layers(params, cfg, 1)
    requests = _load(cfg.vocab_size)
    plain = _tokens(ServeEngine(params, cfg, SCFG), requests)
    engine = SpecServeEngine(params, cfg, SCFG, dparams, dcfg, spec_k=3)
    dispatch.reset_launches()
    got = _tokens(engine, requests)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    assert got == plain
    chunks = sum(-(-len(r.prompt) // SCFG.prefill_chunk) for r in requests)
    want: dict[str, int] = {}
    for c, table, n in ((cfg, DECODE_KERNEL, 3 * engine.spec_rounds),
                        (dcfg, DECODE_KERNEL, 3 * engine.spec_rounds),
                        (cfg, CHUNK_KERNEL, chunks), (dcfg, CHUNK_KERNEL, chunks)):
        for name, count in _per_kernel(c, table, n).items():
            want[name] = want.get(name, 0) + count
    assert {k: launches[k] for k in want} == want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KW))
def test_single_shot_on_card_runs_flash_and_matches_chunked(kind, cuda):
    params, cfg = _params(kind, device=cuda)
    requests = _load(cfg.vocab_size)
    chunked = _tokens(ServeEngine(params, cfg, SCFG), requests)
    engine = ServeEngine(params, cfg, dataclasses.replace(SCFG, prefill_chunk=0))
    dispatch.reset_launches()
    got = _tokens(engine, requests)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    assert got == chunked
    n_attn = sum(k in ("global", "local") for k in _kinds(cfg))
    assert launches["flash_attention"] == n_attn * len(requests)
    assert launches["paged_chunk_attention"] == 0
    for name in ("rglru_scan", "ssd_chunk"):
        n = sum(CHUNK_KERNEL[k] == name for k in _kinds(cfg))
        assert launches[name] == n * sum(len(r.prompt) > 1 for r in requests)
