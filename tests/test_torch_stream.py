"""The port's streaming outer steps against the JAX package's, piece by piece,
on the CPU (no training run: those are ``tests/test_torch_stream_runs.py``).

- The stream partition: the port's leaf → stream map and per-stream specs
  equal JAX's ``stream_partition``, leaf path by leaf path, at S 1, 2, 4
  and 8 on a mixed tree, for every registry arch's ``reduced()`` and for
  paper-small-125m at full width (shapes only, nothing allocated).
- The byte model: ``outer_step_cost`` equals JAX's field for field, the
  ``per_stream`` schedule included, over ``tests/test_streaming.py``'s grid
  of codec × fusing × streams × overlap, with its pinned values.
- ``pack`` / ``unpack_onto`` round-trip each stream bit for bit.
- ``StreamSchedule``'s offsets, due streams, sync indices and its refusal
  of S > m, as JAX's.
- One ``outer_step_stacked_stream`` on one stacked state against JAX's
  (jitted on the int8 wire, whose codec is held against its jitted form): consuming
  and blocking, with and without ``partner_next``, with and without an
  ``active`` mask, on an empty stream (whose int8 sync JAX cannot run: its
  per-replica ``vmap`` over no array raises; held there against JAX's
  plain-wire step, since nothing crosses the wire), over the plain and the
  int8 wire;
  (φ, δ, θ) and the prefetch tree within 1e-6 (one outer step, as
  ``tests/test_torch_train.py`` holds it), every leaf of another stream the
  same tensor, and the int8 wire's gathered values bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.comm import CommConfig as JCommConfig
from repro.comm import bytes_model as jbytes
from repro.comm import exchange as jexchange
from repro.comm import payload as jpayload
from repro.configs import registry as jax_registry
from repro.core import outer as jouter
from repro.models import model as JM
from repro.models.common import values_of
from repro_torch.comm import CommConfig, bytes_model, exchange, payload
from repro_torch.configs import registry
from repro_torch.core import outer
from repro_torch.tree import tree_leaves, tree_map

ATOL = 1e-6
WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU cases gain nothing from more,
    and in a parallel run the other workers' JAX processes keep their
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_paths(tree, prefix=""):
    """Leaf paths of a port tree in flatten order, as "a/b/0/c"."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _port_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in _port_paths(t, f"{prefix}/{i}")]
    return [] if tree is None else [prefix]


def _jax_paths(tree):
    def name(k):
        return str(k.key) if hasattr(k, "key") else str(k.idx)

    return ["/" + "/".join(map(name, path)) for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _spec_fields(spec):
    return [(b.dtype, b.size, [(s.index, tuple(s.shape), s.offset, s.size) for s in b.slots])
            for b in spec.buffers]


def _same_partition(port_tree, jax_tree, streams, fuse=True):
    """The two packages' partitions of one tree agree path by path."""
    paths = _port_paths(port_tree)
    assert paths == _jax_paths(jax_tree)
    got = payload.stream_partition(port_tree, streams, fuse=fuse)
    want = jpayload.stream_partition(jax_tree, streams, fuse=fuse)
    assert dict(zip(paths, got.leaf_stream)) == dict(zip(paths, want.leaf_stream))
    assert got.num_leaves == want.num_leaves and got.stream_count == want.stream_count
    for k in range(streams):
        assert got.leaf_indices(k) == want.leaf_indices(k)
        assert _spec_fields(got.specs[k]) == _spec_fields(want.specs[k])
        assert got.specs[k].nbytes == want.specs[k].nbytes
    assert got.nbytes == want.nbytes
    return got


# a mixed tree: bf16 and fp32 leaves, a scalar, sizes that leave streams empty
MIXED = {"a": ((64, 33), "float32"), "b": ((17,), "float32"), "c": ((300,), "bfloat16"),
         "d": {"x": ((8, 8), "float32"), "y": ((), "float32")}, "e": [((5,), "bfloat16"),
                                                                    ((2, 3), "float32")]}


def _mixed(lead=()):
    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        shape, dt = t
        return payload.LeafShape(lead + shape, dt)

    def build_jax(t):
        if isinstance(t, dict):
            return {k: build_jax(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build_jax(v) for v in t]
        shape, dt = t
        return jax.ShapeDtypeStruct(lead + shape, jnp.dtype(dt))

    return build(MIXED), build_jax(MIXED)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "per-leaf"])
@pytest.mark.parametrize("streams", [1, 2, 4, 8])
def test_stream_partition_matches_jax(streams, fuse):
    port_tree, jax_tree = _mixed((WORLD,))
    part = _same_partition(port_tree, jax_tree, streams, fuse)
    if streams == 1:
        assert _spec_fields(part.specs[0]) == _spec_fields(payload.make_spec(port_tree, fuse=fuse))
    if streams == 8:
        assert any(not part.leaf_indices(k) for k in range(8))   # empty streams exist


@pytest.mark.parametrize("arch", list(jax_registry.ASSIGNED) + ["paper-small-125m"])
def test_stream_partition_of_each_arch_matches_jax(arch):
    """Every registry arch's ``reduced()`` stacked over 4 replicas, S 4."""
    jcfg = jax_registry.get_config(arch).reduced()
    cfg = registry.get_config(arch).reduced()
    one = jax.eval_shape(lambda: values_of(JM.init_params(jax.random.PRNGKey(0), jcfg)))
    jax_tree = jax.tree.map(lambda x: jax.ShapeDtypeStruct((WORLD,) + x.shape, x.dtype), one)
    port_tree = tree_map(lambda x: payload.LeafShape((WORLD,) + x.shape, x.dtype),
                         bytes_model.abstract_params(cfg))
    _same_partition(port_tree, jax_tree, 4)


@pytest.mark.parametrize("streams,want", [
    (4, (1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3)),
    (8, (2, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 6, 7)),
])
def test_stream_partition_full_width_paper_small(streams, want):
    """paper-small-125m at its published width in bf16, 4 replicas: with 4
    streams stream 0 holds no leaf, stream 1 only ``embed/table``."""
    cfg = registry.get_config("paper-small-125m")
    one = jax.eval_shape(lambda: values_of(JM.init_params(
        jax.random.PRNGKey(0), jax_registry.get_config("paper-small-125m"))))
    jax_tree = jax.tree.map(lambda x: jax.ShapeDtypeStruct((WORLD,) + x.shape, x.dtype), one)
    port_tree = tree_map(lambda x: payload.LeafShape((WORLD,) + x.shape, x.dtype),
                         bytes_model.abstract_params(cfg))
    part = _same_partition(port_tree, jax_tree, streams)
    assert part.leaf_stream == want
    if streams == 4:
        assert part.leaf_indices(0) == () and _port_paths(port_tree)[0] == "/embed/table"


# ---------------------------------------------------------------------------
# byte model
# ---------------------------------------------------------------------------


def _bytes_tree():
    """tests/test_streaming.py's tree: fp32 leaves of 64, 8, 256, 16, 32."""
    sizes = [64, 8, 256, 16, 32]
    return ({f"l{i:02d}": payload.LeafShape((n,), "float32") for i, n in enumerate(sizes)},
            {f"l{i:02d}": jax.ShapeDtypeStruct((n,), jnp.float32) for i, n in enumerate(sizes)})


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("codec", ["none", "fp16", "int8"])
@pytest.mark.parametrize("streams", [1, 2, 4])
@pytest.mark.parametrize("overlap", [False, True])
def test_bytes_model_per_stream_matches_jax(fuse, codec, streams, overlap):
    port_tree, jax_tree = _bytes_tree()
    kw = dict(codec=codec, fuse=fuse, streams=streams, overlap=overlap)
    got = bytes_model.outer_step_cost(port_tree, CommConfig(**kw), method="noloco", world=8)
    want = jbytes.outer_step_cost(jax_tree, JCommConfig(**kw), method="noloco", world=8)
    assert got.as_dict() == want.as_dict()
    assert len(got.per_stream) == streams


def test_bytes_model_pinned_values():
    """``tests/test_streaming.py``'s pinned splits: two fp32 leaves of 4096
    and 64 → a (Δ, φ) payload of 33,280 B; the overlap halves the blocking
    part; with 4 streams the largest stream blocks on its Δ alone, 16,384 B;
    fp16 halves the wire; and a mixed bf16/fp32 tree with empty streams."""
    tree = {"a": payload.LeafShape((64, 64), "float32"), "b": payload.LeafShape((64,), "float32")}
    legacy = bytes_model.outer_step_cost(tree, CommConfig(), method="noloco")
    assert legacy.payload_bytes == legacy.blocking_bytes == 33280
    assert legacy.stream_count == 1 and legacy.overlapped_bytes == 0
    ov = bytes_model.outer_step_cost(tree, CommConfig(overlap=True), method="noloco")
    assert ov.payload_bytes == 33280 and ov.blocking_bytes == ov.overlapped_bytes == 16640
    s4 = bytes_model.outer_step_cost(tree, CommConfig(streams=4, overlap=True), method="noloco")
    assert s4.payload_bytes == 33280 and s4.blocking_bytes == 16640
    assert max(s.blocking_bytes for s in s4.per_stream) == 16384
    fp16 = bytes_model.outer_step_cost(tree, CommConfig(codec="fp16", streams=4, overlap=True),
                                       method="noloco")
    assert fp16.payload_bytes == 16640 and fp16.blocking_bytes == 8320
    port_tree, jax_tree = _mixed()
    for codec in ("none", "int8"):
        cfg = dict(codec=codec, streams=8, overlap=True)
        got = bytes_model.outer_step_cost(port_tree, CommConfig(**cfg))
        assert got.as_dict() == jbytes.outer_step_cost(jax_tree, JCommConfig(**cfg)).as_dict()
        assert any(s.payload_bytes == 0 and s.messages == 0 for s in got.per_stream)
    with pytest.raises(ValueError, match="noloco-only"):
        bytes_model.outer_step_cost(tree, CommConfig(streams=2), method="diloco", world=4)


# ---------------------------------------------------------------------------
# pack / unpack_onto, the schedule
# ---------------------------------------------------------------------------


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(sizes=st.lists(st.integers(0, 40), min_size=1, max_size=7),
       bf16=st.lists(st.booleans(), min_size=7, max_size=7),
       streams=st.integers(1, 5), fuse=st.booleans(), lead=st.integers(0, 1))
def test_pack_unpack_onto_round_trips_each_stream(sizes, bf16, streams, fuse, lead):
    """Each stream's leaves packed with its spec and unpacked onto a zero
    tree come back bit for bit; the other streams' leaves are the base's
    own tensors."""
    gen = torch.Generator().manual_seed(len(sizes) * 31 + streams)
    batch = (3,) if lead else ()
    tree = {f"l{i}": torch.randn(batch + ((n,) if n else ()), generator=gen).to(
        torch.bfloat16 if bf16[i] else torch.float32) for i, n in enumerate(sizes)}
    shapes = tree_map(lambda x: payload.LeafShape(tuple(x.shape[lead:]), str(x.dtype)[6:]), tree)
    part = payload.stream_partition(shapes, streams, fuse=fuse)
    base = tree_map(torch.zeros_like, tree)
    leaves, base_leaves = tree_leaves(tree), tree_leaves(base)
    for k in range(streams):
        buffers, spec = payload.pack(tree, spec=part.specs[k], lead=lead)
        assert len(buffers) == len(spec.buffers)
        out = tree_leaves(payload.unpack_onto(buffers, spec, base))
        for i, (got, want, b) in enumerate(zip(out, leaves, base_leaves)):
            if i in part.leaf_indices(k):
                assert got.dtype == want.dtype and torch.equal(got, want)
            else:
                assert got is b
    with pytest.raises(ValueError, match="leaves"):
        payload.unpack_onto([], part.specs[0], {})


@pytest.mark.parametrize("m,s", [(10, 1), (5, 4), (4, 4), (7, 3)])
def test_stream_schedule_matches_jax(m, s):
    got, want = outer.StreamSchedule(m, s), jouter.StreamSchedule(m, s)
    assert got.offsets == want.offsets
    due = [got.due(t) for t in range(5 * m)]
    assert due == [want.due(t) for t in range(5 * m)]
    for t, k in enumerate(due):
        if k is not None:
            assert got.sync_index(k, t) == want.sync_index(k, t)
    assert [t for t, k in enumerate(due) if k is not None][:s] == [m + o for o in got.offsets]
    with pytest.raises(ValueError, match="not due"):
        got.sync_index(0, 1)
    with pytest.raises(ValueError, match="must not exceed"):
        outer.StreamSchedule(m, m + 1)


# ---------------------------------------------------------------------------
# one stream's outer step
# ---------------------------------------------------------------------------


def _state(seed=0):
    """θ, φ, δ and a stale prefetch tree over MIXED stacked on WORLD replicas,
    as numpy (fp32 values rounded to each leaf's dtype)."""
    rng = np.random.default_rng(seed)
    port_tree, _ = _mixed((WORLD,))

    def draw(scale):
        return tree_map(lambda x: torch.from_numpy(
            (scale * rng.normal(size=x.shape)).astype(np.float32)).to(getattr(torch, x.dtype)),
            port_tree)

    phi = draw(1.0)
    theta = tree_map(lambda p, n: (p.float() + n.float()).to(p.dtype), phi, draw(0.05))
    return {"theta": theta, "phi": phi, "delta": draw(0.01), "pre": draw(1.0)}


def _to_jax(tree):
    return tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def _close(port_tree, jax_tree):
    got, want = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == jnp.dtype(w.dtype).name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=ATOL, rtol=0)


CASES = {
    "block": dict(consume=False, next=False, active=False),
    "block+presend": dict(consume=False, next=True, active=False),
    "consume+presend": dict(consume=True, next=True, active=False),
    "consume+presend+mask": dict(consume=True, next=True, active=True),
    "block+mask": dict(consume=False, next=False, active=True),
}


@pytest.mark.parametrize("case,codec", [(c, "none") for c in CASES] + [
    ("block", "int8"), ("block+presend", "int8"), ("consume+presend+mask", "int8"),
    ("empty-stream", "none"), ("empty-stream", "int8")])
def test_outer_step_stacked_stream_matches_jax(case, codec):
    opts = CASES.get(case, dict(consume=True, next=True, active=False))
    streams = 8 if case == "empty-stream" else 4
    port_tree, jax_tree = _mixed((WORLD,))
    part = payload.stream_partition(port_tree, streams)
    jpart = jpayload.stream_partition(jax_tree, streams)
    k = next(i for i in range(streams) if not part.leaf_indices(i)) if case == "empty-stream" \
        else max(range(streams), key=lambda i: len(part.leaf_indices(i)))
    s = _state()
    partner, nxt = np.array([2, 3, 0, 1]), np.array([1, 0, 3, 2])
    active = np.array([True, False, True, True]) if opts["active"] else None
    ocfg = dict(method="noloco", alpha=0.5, beta=0.7, seed=2)
    comm = dict(codec=codec, chunk=64)
    # JAX's stacked stream step cannot code an empty stream (its per-replica
    # vmap gets no array and raises); nothing crosses that wire, so the
    # reference there is its plain-wire step
    jcomm = dict(comm, codec="none") if case == "empty-stream" else comm
    phi_pre = s["pre"] if opts["consume"] else None
    pstate = outer.OuterState(phi=s["phi"], delta=s["delta"], step=5)
    pnew, ptheta, ppre = outer.outer_step_stacked_stream(
        pstate, s["theta"], outer.OuterConfig(**ocfg), stream=k, partition=part,
        partner=partner, active=active, phi_pre=phi_pre, consume_prefetch=opts["consume"],
        partner_next=nxt if opts["next"] else None, comm_cfg=CommConfig(**comm))

    def jstep(phi, delta, theta, pre):
        return jouter.outer_step_stacked_stream(
            jouter.OuterState(phi=phi, delta=delta, step=jnp.int32(5)), theta,
            jouter.OuterConfig(**ocfg), stream=k, partition=jpart, partner=jnp.asarray(partner),
            active=None if active is None else jnp.asarray(active), phi_pre=pre,
            consume_prefetch=opts["consume"],
            partner_next=jnp.asarray(nxt) if opts["next"] else None,
            comm_cfg=JCommConfig(**jcomm))

    run = jax.jit(jstep) if codec == "int8" else jstep   # the int8 codec's jitted form
    jnew, jtheta, jpre = run(_to_jax(s["phi"]), _to_jax(s["delta"]), _to_jax(s["theta"]),
                             None if phi_pre is None else _to_jax(phi_pre))
    assert pnew.step == 6
    _close(pnew.phi, jnew.phi)
    _close(pnew.delta, jnew.delta)
    _close(ptheta, jtheta)
    assert (ppre is None) == (jpre is None) == (not opts["next"])
    if ppre is not None:
        _close(ppre, jpre)
    # the other streams' leaves pass through as the same tensors
    idxs = set(part.leaf_indices(k))
    for name, new, old in (("phi", pnew.phi, s["phi"]), ("delta", pnew.delta, s["delta"]),
                           ("theta", ptheta, s["theta"])):
        for i, (a, b) in enumerate(zip(tree_leaves(new), tree_leaves(old))):
            assert (a is b) == (i not in idxs), (name, i)
    if ppre is not None:
        base = tree_leaves(phi_pre if phi_pre is not None else s["phi"])
        for i, (a, b) in enumerate(zip(tree_leaves(ppre), base)):
            assert (a is b) == (i not in idxs)
    if not idxs or codec == "none":   # a plain wire gathers exact values
        return
    if active is None:   # θ_k and φ′_k are one tensor after the sync
        assert all(tree_leaves(ptheta)[i] is tree_leaves(pnew.phi)[i] for i in idxs)
    # each wire's gathered values, bit for bit
    leaves = {n: [tree_leaves(s[n])[i] for i in sorted(idxs)] for n in ("theta", "phi")}
    delta_k = outer.outer_gradient(leaves["theta"], leaves["phi"])
    jdelta_k = jouter.outer_gradient(_to_jax(leaves["theta"]), _to_jax(leaves["phi"]))
    pcomm = exchange.StackedGather(torch.as_tensor(partner), CommConfig(**comm))
    jcomm = jexchange.StackedGather(jnp.asarray(partner), JCommConfig(**comm))
    got = exchange.exchange_gossip(pcomm, delta_k, leaves["phi"])
    want = jax.jit(lambda d, p: jexchange.exchange_gossip(jcomm, d, p))(jdelta_k,
                                                                        _to_jax(leaves["phi"]))
    sent = exchange.presend(pcomm, leaves["phi"])
    jsent = jax.jit(lambda p: jexchange.presend(jcomm, p))(_to_jax(leaves["phi"]))
    for g, w in zip(tree_leaves((got, sent)), jax.tree.leaves((want, jsent))):
        assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))


def test_stream_step_refuses_diloco_and_a_missing_prefetch():
    port_tree, _ = _mixed((WORLD,))
    part = payload.stream_partition(port_tree, 2)
    s = _state()
    st_ = outer.OuterState(phi=s["phi"], delta=s["delta"])
    with pytest.raises(ValueError, match="NoLoCo-only"):
        outer.outer_step_stacked_stream(st_, s["theta"], outer.OuterConfig(method="diloco", alpha=0.3),
                                        stream=0, partition=part, partner=np.arange(WORLD))
    with pytest.raises(ValueError, match="requires phi_pre"):
        outer.outer_step_stacked_stream(st_, s["theta"], outer.OuterConfig(), stream=0,
                                        partition=part, partner=np.arange(WORLD),
                                        consume_prefetch=True)


def test_one_stream_covering_everything_is_the_plain_outer_step():
    """A single stream over the whole tree, blocking, gives
    ``outer_step_stacked``'s (φ, δ, θ) bit for bit."""
    port_tree, _ = _mixed((WORLD,))
    s = _state(1)
    partner = np.array([1, 0, 3, 2])
    cfg = outer.OuterConfig(seed=3)
    st_ = outer.OuterState(phi=s["phi"], delta=s["delta"], step=2)
    a, ta = outer.outer_step_stacked(st_, s["theta"], cfg, partner=partner)
    b, tb, _ = outer.outer_step_stacked_stream(st_, s["theta"], cfg, stream=0,
                                               partition=payload.stream_partition(port_tree, 1),
                                               partner=partner)
    for x, y in zip(tree_leaves((a.phi, a.delta, ta)), tree_leaves((b.phi, b.delta, tb))):
        assert torch.equal(x, y)
    assert a.step == b.step == 3
