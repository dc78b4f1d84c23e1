"""The port's elastic tables, fault plans, clocks and masked steps against
the JAX package's, on the CPU, without a training run.

* ``Membership`` (drop, add, without, views) and its errors, message for
  message.
* ``elastic_partner_table`` with and without partition groups, the
  hypercube tables, ``elastic_route_permutation`` and ``all_pairs_seen``
  over worlds 1–12, masks, groups, seeds and steps: identical tables.
* ``stream_assignment`` and ``ElasticContext.plan_round`` / ``state_dict``.
* ``FaultPlan``'s JSON round trip (the port reads the reference's JSON and
  writes the same) and its validation messages.
* ``ReplicaClock`` traces for the rate sweeps of
  ``tests/test_async_clock.py``: identical due sets, staleness and sync
  counts.
* ``stale_discount`` within 1e-6 (fp32 products), τ = 0 exactly 1.0; one
  masked stale outer step against ``outer_step_stacked`` within 1e-6.
* One masked inner step (AdamW with ``active``) of both packages'
  ``GossipTrainer`` within 1e-6, with the frozen rows bit-identical to
  their values before the step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.core import elastic as jelastic
from repro.core import noloco as jnoloco
from repro.core import outer as jouter
from repro.core import pairing as jpairing
from repro.optim import AdamWConfig as JAdamWConfig
from repro.sim import faults as jfaults
from repro.sim.cluster import ReplicaClock as JReplicaClock
from repro_torch.comm import CommConfig
from repro_torch.core import elastic, noloco, outer, pairing
from repro_torch.optim import AdamWConfig
from repro_torch.sim import FaultPlan, ReplicaClock
from repro_torch.tree import tree_leaves, tree_map


def _masks(world, rng):
    """Full, one dropped, about half dropped, and a single survivor."""
    out = [(True,) * world]
    if world > 1:
        out.append(tuple(i != world // 2 for i in range(world)))
        half = rng.random(world) < 0.5
        half[rng.integers(world)] = True
        out.append(tuple(bool(b) for b in half))
        out.append(tuple(i == world - 1 for i in range(world)))
    return out


def _groups(world, rng):
    """No partition, two halves, and three groups leaving one replica out."""
    out = [None]
    if world >= 2:
        out.append([list(range(world // 2)), list(range(world // 2, world))])
    if world >= 4:
        perm = rng.permutation(world)
        out.append([perm[:1].tolist(), perm[1:world // 2].tolist(),
                    perm[world // 2:world - 1].tolist()])
    return out


# ---------------------------------------------------------------------------
# Membership and pairing tables
# ---------------------------------------------------------------------------


def test_membership_api_and_errors_match():
    for mod in (pairing, jpairing):
        m = mod.Membership.full(6)
        assert m.is_full and m.epoch == 0 and m.num_active == 6
        d = m.drop([1, 4])
        assert d.active_ids == (0, 2, 3, 5) and d.epoch == 1 and not d.is_full
        back = d.add([1])
        assert back.epoch == 2 and back.active_ids == (0, 1, 2, 3, 5)
        t = back.without([0])
        assert t.epoch == back.epoch and t.active_ids == (1, 2, 3, 5)
        assert back.without([]) is back
        np.testing.assert_array_equal(d.active_array(), [1, 0, 1, 1, 0, 1])
    bad = [
        (lambda mod: mod.Membership.full(6).drop([1]).drop([1]), "already inactive"),
        (lambda mod: mod.Membership.full(6).add([0]), "already active"),
        (lambda mod: mod.Membership(world=2, mask=(False, False)), "at least one active"),
        (lambda mod: mod.Membership.full(4).drop([9]), "outside world"),
        (lambda mod: mod.Membership(world=3, mask=(True,)), "mask length"),
        (lambda mod: mod.Membership(world=0, mask=()), "world >= 1"),
    ]
    for make, match in bad:
        msgs = []
        for mod in (pairing, jpairing):
            with pytest.raises(ValueError, match=match) as err:
                make(mod)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_elastic_partner_tables_match_over_worlds_masks_groups_seeds():
    rng = np.random.default_rng(0)
    cases = 0
    for world in range(1, 13):
        for mask in _masks(world, rng):
            pm = pairing.Membership(world=world, mask=mask)
            jm = jpairing.Membership(world=world, mask=mask)
            for groups in _groups(world, rng):
                for seed in (0, 7):
                    for step in (0, 1, 5):
                        got = pairing.elastic_partner_table(step, pm, seed=seed, groups=groups)
                        want = jpairing.elastic_partner_table(step, jm, seed=seed, groups=groups)
                        np.testing.assert_array_equal(got, want)
                        assert (got[got] == np.arange(world)).all()   # an involution
                        assert pairing.elastic_ppermute_pairs(step, pm, seed=seed, groups=groups) \
                            == jpairing.elastic_ppermute_pairs(step, jm, seed=seed, groups=groups)
                        cases += 1
                route = pairing.elastic_route_permutation(3, pm, seed=1)
                np.testing.assert_array_equal(
                    route, jpairing.elastic_route_permutation(3, jm, seed=1))
    assert cases > 500
    # full membership, no groups: the static table, bit for bit
    for world in (2, 7, 8):
        for step in range(4):
            np.testing.assert_array_equal(
                pairing.elastic_partner_table(step, pairing.Membership.full(world), seed=3),
                pairing.partner_table(step, world, seed=3))


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_hypercube_tables_match(world):
    rng = np.random.default_rng(world)
    for seed in (0, 5):
        for step in range(7):
            assert pairing.hypercube_dim(step, world, seed=seed) == \
                jpairing.hypercube_dim(step, world, seed=seed)
            np.testing.assert_array_equal(pairing.hypercube_partner_table(step, world, seed=seed),
                                          jpairing.hypercube_partner_table(step, world, seed=seed))
            for mask in _masks(world, rng):
                for groups in _groups(world, rng):
                    np.testing.assert_array_equal(
                        pairing.elastic_hypercube_partner_table(
                            step, pairing.Membership(world=world, mask=mask), seed=seed,
                            groups=groups),
                        jpairing.elastic_hypercube_partner_table(
                            step, jpairing.Membership(world=world, mask=mask), seed=seed,
                            groups=groups))
    for mod in (pairing, jpairing):
        with pytest.raises(ValueError, match="power-of-two"):
            mod.hypercube_dim(0, 6)


@pytest.mark.parametrize("world", [3, 8, 12])
def test_all_pairs_seen_matches(world):
    for steps in (1, 4, 9):
        np.testing.assert_array_equal(pairing.all_pairs_seen(steps, world, seed=2),
                                      jpairing.all_pairs_seen(steps, world, seed=2))


def test_partition_group_errors_match():
    for groups, match in (([[0, 1], [1, 2]], "disjoint"), ([[0, 9]], "outside world")):
        msgs = []
        for mod in (pairing, jpairing):
            with pytest.raises(ValueError, match=match) as err:
                mod.elastic_partner_table(0, mod.Membership.full(4), groups=groups)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# ElasticContext and stream assignment
# ---------------------------------------------------------------------------


def test_stream_assignment_matches():
    rng = np.random.default_rng(1)
    for world in range(1, 11):
        for mask in _masks(world, rng):
            pm = pairing.Membership(world=world, mask=mask)
            jm = jpairing.Membership(world=world, mask=mask)
            for t in range(7):
                np.testing.assert_array_equal(elastic.stream_assignment(pm, t),
                                              jelastic.stream_assignment(jm, t))


def test_plan_round_and_state_dict_match():
    """Stragglers, an all-absent round, partitions and the checkpoint view,
    step for step through both contexts."""
    pc = elastic.ElasticContext(world=6)
    jc = jelastic.ElasticContext(world=6)
    script = [
        ("drop", [2]), ("absent", {0, 4}), ("partition", [[0, 1, 2], [3, 4, 5]]),
        ("absent", set()), ("absent", {0, 1, 3, 4, 5}), ("heal", None), ("add", [2]),
        ("absent", {9}),
    ]
    for step, (op, arg) in enumerate(script):
        for ctx, mod in ((pc, pairing), (jc, jpairing)):
            if op == "drop":
                ctx.set_membership(ctx.membership.drop(arg))
            elif op == "add":
                ctx.set_membership(ctx.membership.add(arg))
            elif op == "partition":
                ctx.set_partition(arg)
            elif op == "heal":
                ctx.set_partition(None)
            else:
                ctx.round_absent = frozenset(arg)
        fn = lambda mod, ctx: (lambda parts: mod.elastic_partner_table(
            step, parts, seed=4, groups=ctx.partition))
        pp, jp = pc.plan_round(fn(pairing, pc)), jc.plan_round(fn(jpairing, jc))
        assert pp.all_absent == jp.all_absent
        assert pp.participants.mask == jp.participants.mask
        np.testing.assert_array_equal(pp.partner, jp.partner)
        assert (pp.active is None) == (jp.active is None)
        if pp.active is not None:
            np.testing.assert_array_equal(pp.active, jp.active)
        for k, v in pc.state_dict().items():
            want = jc.state_dict()[k]
            np.testing.assert_array_equal(v, want)
            assert np.asarray(v).dtype == np.asarray(want).dtype
    assert pp.all_absent is False and pc.is_full
    restored = elastic.ElasticContext(world=6)
    pc.set_partition([[5, 1], [0, 2, 3]])
    restored.load_state_dict(pc.state_dict())
    jrestored = jelastic.ElasticContext(world=6)
    jrestored.load_state_dict(pc.state_dict())
    assert restored.partition == jrestored.partition == ((1, 5), (0, 2, 3))
    assert restored.membership.epoch == jrestored.membership.epoch == 2
    # the async clock's step gate composes with membership
    pc.tick_active = np.array([True, False, True, True, True, True])
    np.testing.assert_array_equal(pc.active_array(), pc.tick_active)
    pc.tick_active = np.ones(6, bool)
    assert pc.active_array() is None


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

PLAN = [
    {"kind": "drop", "round": 2, "replicas": [3, 5]},
    {"kind": "straggle", "step": 7, "replicas": [1], "rounds": 2},
    {"kind": "rate", "round": 0, "replicas": [2], "rate": 0.5},
    {"kind": "partition", "round": 4, "groups": [[0, 1], [2, 3]]},
    {"kind": "heal", "round": 6},
    {"kind": "rejoin", "round": 5, "replicas": [3], "source": 0},
]


def test_fault_plan_json_round_trip(tmp_path):
    jplan = jfaults.FaultPlan.build(PLAN)
    plan = FaultPlan.from_json(jplan.to_json())
    assert plan.to_json() == jplan.to_json()
    p = str(tmp_path / "plan.json")
    plan.save(p)
    loaded = FaultPlan.load(p)
    assert loaded == plan and jfaults.FaultPlan.load(p) == jplan
    loaded.validate(world=8)
    for m in (1, 5):
        assert [e.resolved_step(m) for e in loaded.events] == \
            [e.resolved_step(m) for e in jplan.events]
        assert [e.effect_end_step(m) for e in loaded.events] == \
            [e.effect_end_step(m) for e in jplan.events]
        assert loaded.max_effect_step(m) == jplan.max_effect_step(m)
        assert loaded.max_anchor_step(m) == jplan.max_anchor_step(m)
        for step in range(0, 40):
            assert [e.as_dict() for e in loaded.events_at(step, m)] == \
                [e.as_dict() for e in jplan.events_at(step, m)]
    assert [e.as_dict() for e in loaded.rate_events()] == [e.as_dict() for e in jplan.rate_events()]
    assert FaultPlan().max_effect_step(5) == -1


@pytest.mark.parametrize("events,world", [
    ([{"kind": "nuke", "step": 0}], 4),
    ([{"kind": "drop", "replicas": [0]}], 4),
    ([{"kind": "drop", "step": 0, "round": 1, "replicas": [0]}], 4),
    ([{"kind": "drop", "step": -1, "replicas": [0]}], 4),
    ([{"kind": "drop", "step": 0, "replicas": [9]}], 4),
    ([{"kind": "partition", "step": 0, "groups": [[0, 1], [1, 2]]}], 4),
    ([{"kind": "partition", "step": 0, "groups": [[0, 7]]}], 4),
    ([{"kind": "partition", "step": 0}], 4),
    ([{"kind": "rejoin", "round": 1}], 4),
    ([{"kind": "straggle", "round": 1, "replicas": [0], "rounds": 0}], 4),
    ([{"kind": "rate", "round": 0, "replicas": [0], "rate": 1.5}], 4),
    ([{"kind": "rejoin", "round": 1, "replicas": [0], "source": 6}], 4),
], ids=["kind", "anchor", "both", "negative", "replica", "disjoint", "group-id", "groups",
        "replicas", "rounds", "rate", "source"])
def test_fault_plan_validation_messages_match(events, world):
    msgs = []
    for build in (jfaults.FaultPlan.build, FaultPlan.build):
        with pytest.raises(ValueError) as err:
            build(events).validate(world)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="unknown fault event fields"):
        FaultPlan.build([{"kind": "drop", "step": 0, "replicas": [0], "when": 3}])


# ---------------------------------------------------------------------------
# The asynchronous replica clock
# ---------------------------------------------------------------------------

RATE_CHOICES = (1.0, 0.5, 1.0 / 3.0, 0.25, 0.1)


def _trace(cls, world, rates, m, ticks, member_fn=None):
    clock = cls(world, m)
    for r, rho in enumerate(rates):
        clock.set_rate([r], rho)
    out = []
    for t in range(ticks):
        member = np.ones(world, bool) if member_fn is None else member_fn(t)
        grant = clock.tick(member)
        due = clock.due_mask(member)
        tau = clock.staleness()
        if due.any():
            clock.advance_sync(due)
        out.append((grant.copy(), due.copy(), tau.copy(), clock.sync_count.copy()))
    return clock, out


@pytest.mark.parametrize("sweep", range(6))
def test_replica_clock_traces_match(sweep):
    """The rate sweeps of ``tests/test_async_clock.py`` (random rates,
    rate 1, a constant-rate straggler, members leaving and returning):
    identical grants, due sets, staleness and sync counts at every tick, and
    equal checkpoint views."""
    rng = np.random.default_rng(sweep)
    world, m = int(rng.integers(2, 13)), int(rng.integers(1, 7))
    if sweep == 0:
        rates = [1.0] * world
    elif sweep == 1:
        rates = [1.0] * world
        rates[int(rng.integers(world))] = float(rng.choice([0.5, 0.25]))
    else:
        rates = [RATE_CHOICES[int(rng.integers(len(RATE_CHOICES)))] for _ in range(world)]
    member_fn = None
    if sweep == 5:
        gone = int(rng.integers(world))
        member_fn = lambda t: np.arange(world) != gone if 10 <= t < 25 else np.ones(world, bool)
    pc, pt = _trace(ReplicaClock, world, rates, m, 12 * m + 30, member_fn)
    jc, jt = _trace(JReplicaClock, world, rates, m, 12 * m + 30, member_fn)
    for a, b in zip(pt, jt):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for k, v in pc.state_dict().items():
        np.testing.assert_array_equal(v, jc.state_dict()[k])
    resumed = ReplicaClock(world, m)
    resumed.load_state_dict(jc.state_dict())
    assert resumed.merged_tick == pc.merged_tick
    np.testing.assert_array_equal(resumed.credit, pc.credit)


# ---------------------------------------------------------------------------
# Stale discount and masked steps
# ---------------------------------------------------------------------------


def _tree(rng, r, dtype=np.float32):
    return {"a": rng.normal(size=(r, 5, 3)).astype(dtype),
            "b": [rng.normal(size=(r, 7)).astype(dtype)]}


def test_stale_discount_matches():
    rng = np.random.default_rng(3)
    tree = _tree(rng, 5)
    tau = np.array([0, 1, 3, 0, 7], np.float32)
    got = outer.stale_discount(tree_map(torch.from_numpy, tree), torch.from_numpy(tau))
    want = jouter.stale_discount(jax.tree.map(jnp.asarray, tree), jnp.asarray(tau))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    for g, x in zip(tree_leaves(got), tree_leaves(tree)):   # τ = 0 rows: exactly 1.0
        np.testing.assert_array_equal(g.numpy()[[0, 3]], x[[0, 3]])
    scalar = outer.stale_discount(tree_map(torch.from_numpy, tree), 1.0)
    np.testing.assert_allclose(scalar["a"].numpy(), tree["a"] * np.float32(0.5), rtol=1e-6)


@pytest.mark.parametrize("codec", ["none", "bf16"])
def test_masked_stale_outer_step_matches(codec):
    """A merged tick: pairing over every participant, the update applied by
    the due set alone, the wire Δ discounted by 1/(1+τ)."""
    rng = np.random.default_rng(4)
    r = 6
    theta, phi, dmom = _tree(rng, r), _tree(rng, r), _tree(rng, r)
    partner = pairing.elastic_partner_table(2, pairing.Membership.full(r), seed=0)
    active = np.array([True, False, True, True, False, True])
    tau = np.array([1, 0, 0, 2, 0, 0], np.float32)
    cfg = outer.OuterConfig(method="noloco", inner_steps=3, stale="momentum")
    jcfg = jouter.OuterConfig(method="noloco", inner_steps=3, stale="momentum")
    t = lambda x: tree_map(torch.from_numpy, x)
    j = lambda x: jax.tree.map(jnp.asarray, x)
    got_state, got_theta = outer.outer_step_stacked(
        outer.OuterState(phi=t(phi), delta=t(dmom), step=2), t(theta), cfg, partner=partner,
        active=active, comm_cfg=CommConfig(codec=codec), staleness=torch.from_numpy(tau))
    want_state, want_theta = jouter.outer_step_stacked(
        jouter.OuterState(phi=j(phi), delta=j(dmom), step=jnp.int32(2)), j(theta), jcfg,
        partner=jnp.asarray(partner), active=jnp.asarray(active),
        comm_cfg=JCommConfig(codec=codec), staleness=jnp.asarray(tau))
    for got, want in ((got_theta, want_theta), (got_state.phi, want_state.phi),
                      (got_state.delta, want_state.delta)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    for g, x in zip(tree_leaves(got_state.phi), tree_leaves(phi)):   # frozen: untouched
        np.testing.assert_array_equal(g.numpy()[~active], x[~active])
    # τ = 0 everywhere: exactly the undiscounted step
    plain = outer.outer_step_stacked(
        outer.OuterState(phi=t(phi), delta=t(dmom), step=2), t(theta), cfg, partner=partner,
        active=active, comm_cfg=CommConfig(codec=codec))[0]
    zero = outer.outer_step_stacked(
        outer.OuterState(phi=t(phi), delta=t(dmom), step=2), t(theta), cfg, partner=partner,
        active=active, comm_cfg=CommConfig(codec=codec), staleness=torch.zeros(r))[0]
    for a, b in zip(tree_leaves(plain.phi), tree_leaves(zero.phi)):
        assert torch.equal(a, b)


def _quad_loss_jax(params, batch, rng):
    return sum(jnp.sum((p * batch["x"].mean()) ** 2) for p in jax.tree.leaves(params))


def _quad_loss_torch(params, batch):
    scale = batch["x"].flatten(1).mean(1)
    return sum(((p * scale.reshape((-1,) + (1,) * (p.dim() - 1))) ** 2).flatten(1).sum(1)
               for p in tree_leaves(params))


def test_masked_inner_step_matches_and_freezes():
    """Two inner steps of both trainers with an active mask; the frozen
    rows keep θ, both moments and the step count bit for bit (so a frozen
    replica's schedule stands still), the active rows follow JAX within
    1e-6, and an all-True mask gives the unmasked step's bits."""
    rng = np.random.default_rng(5)
    r = 5
    params = _tree(rng, r)
    batch = {"x": rng.normal(size=(r, 2, 3)).astype(np.float32)}
    active = np.array([True, False, True, False, True])
    sched = lambda step: 1e-2 * (step.astype(jnp.float32) + 1.0) / 3.0
    jtrainer = jnoloco.GossipTrainer(jnoloco.TrainerConfig(
        outer=jouter.OuterConfig(inner_steps=4), inner=JAdamWConfig(lr=sched)), _quad_loss_jax)
    ptrainer = noloco.GossipTrainer(noloco.TrainerConfig(
        outer=outer.OuterConfig(inner_steps=4),
        inner=AdamWConfig(lr=lambda step: 1e-2 * (step.float() + 1.0) / 3.0)), _quad_loss_torch)
    jstate = jtrainer.init(jax.tree.map(jnp.asarray, params))
    pstate = ptrainer.init(tree_map(torch.from_numpy, params))
    unmasked = ptrainer.init(tree_map(torch.from_numpy, params))
    jbatch = {"x": jnp.asarray(batch["x"])}
    pbatch = {"x": torch.from_numpy(batch["x"])}
    for _ in range(2):
        jstate, _ = jtrainer.inner_step(jstate, jbatch, jax.random.PRNGKey(0),
                                        jnp.asarray(active))
        pstate, _ = ptrainer.inner_step(pstate, pbatch, active=torch.from_numpy(active))
        unmasked, _ = ptrainer.inner_step(unmasked, pbatch, active=torch.ones(r, dtype=torch.bool))
    assert pstate.opt.count.tolist() == np.asarray(jstate.opt.count).tolist() == [2, 0, 2, 0, 2]
    for got, want, start in ((pstate.theta, jstate.theta, params),
                             (pstate.opt.mu, jstate.opt.mu, None),
                             (pstate.opt.nu, jstate.opt.nu, None)):
        for g, w, s in zip(tree_leaves(got), jax.tree.leaves(want),
                           tree_leaves(start) if start else [None] * 2):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
            frozen = g.numpy()[~active]
            np.testing.assert_array_equal(frozen, 0 if s is None else s[~active])
    plain = ptrainer.init(tree_map(torch.from_numpy, params))
    for _ in range(2):
        plain, _ = ptrainer.inner_step(plain, pbatch)
    for a, b in zip(tree_leaves(plain.theta) + tree_leaves(plain.opt.nu),
                    tree_leaves(unmasked.theta) + tree_leaves(unmasked.opt.nu)):
        assert torch.equal(a, b)
