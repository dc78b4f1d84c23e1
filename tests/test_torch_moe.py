"""The port's MoE block against ``repro.models.moe`` on the CPU.

Weights come from the JAX initialiser; inputs and cotangents from numpy with
a seed.  Both run in fp32 at expert parallelism 1 (``ShardCtx.local()``).
Tolerances: outputs within 1e-5 absolute (products and sums in another
order), gradients within 1e-5 absolute plus 1e-5 relative (the router's
reach ~15 at these shapes, where fp32 sums in another order differ by
~1e-6 relative), the auxiliary loss within 1e-6; routing decisions
(the top-k expert ids) identical, since a flipped choice would move a
token's output by a whole expert's contribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import moe as jmoe
from repro.models.common import values_of
from repro.parallel.sharding import ShardCtx
from repro_torch.configs import registry
from repro_torch.models import moe
from repro_torch.tree import tree_leaves, tree_map

CTX = ShardCtx.local()
ATOL, GRAD_RTOL, AUX_ATOL = 1e-5, 1e-5, 1e-6
ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: these small CPU runs gain
    nothing from more, and in a parallel test run the other workers'
    multi-device JAX subprocesses need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    kw = dict(kw, dtype="float32", remat=False)
    return jax_registry.get_config(arch).reduced(**kw), registry.get_config(arch).reduced(**kw)


def _jax_params(jcfg, seed):
    return jax.tree.map(np.asarray, values_of(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)))


def _jax_top_e(p, x, k):
    """The reference's routing decisions: top-k expert ids of each token."""
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, x.shape[-1]) @ p["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def _check_routing(jp, p, x, k):
    """Routing decisions of the port and the reference on the same tokens:
    the count that differ (0 expected) and the smallest top-k margin."""
    want = _jax_top_e(jp, x, k)
    xt = torch.from_numpy(x).reshape(1, -1, x.shape[-1])
    probs, _, top_e = moe.route(p["router"][None], xt, k)
    srt = probs[0].sort(dim=-1, descending=True).values
    margin = (srt[:, k - 1] - srt[:, k]).min().item()
    return int((top_e[0].numpy() != want).sum()), margin


def _drops(cfg, p, x):
    """Assignments over capacity, from the expert counts."""
    t = x.shape[0] * x.shape[1]
    _, _, top_e = moe.route(p["router"][None], torch.from_numpy(x).reshape(1, t, -1),
                            cfg.num_experts_per_token)
    cap = moe.capacity(t, cfg.num_experts_per_token, cfg.num_experts, cfg.moe_capacity_factor)
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.num_experts)
    return int((counts - cap).clamp_min(0).sum())


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cap1.25", "cap0.5-drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, capacity_factor):
    """One layer on (B 2, S 24): output, aux and the gradients of
    ⟨y, g⟩ + aux for every weight and the input."""
    jcfg, cfg = _configs(arch, moe_capacity_factor=capacity_factor)
    jp = _jax_params(jcfg, 0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.apply_moe(p, jcfg, x, CTX)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    p = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(), jp)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(p, cfg, xt)
    ((y * torch.from_numpy(g)).sum() + aux).backward()

    flips, margin = _check_routing(jp, tree_map(lambda t: t.detach(), p), x,
                                   cfg.num_experts_per_token)
    assert flips == 0, f"{flips} routing decisions differ (smallest top-k margin {margin:.3e})"
    drops = _drops(cfg, tree_map(lambda t: t.detach(), p), x)
    assert (drops > 0) == (capacity_factor < 1), drops
    assert aux.shape == () and y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=AUX_ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=ATOL, rtol=GRAD_RTOL)
    assert sorted(p) == sorted(jgp)
    for name in p:
        np.testing.assert_allclose(p[name].grad.numpy(), np.asarray(jgp[name]), atol=ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_moe_is_the_reference_vmapped(arch):
    """x (R, B, S, d) on weights stacked over R: routing, capacity and aux
    per replica (the reference vmaps its loss over replicas), at a capacity
    factor that drops assignments."""
    jcfg, cfg = _configs(arch, moe_capacity_factor=0.5)
    reps = [_jax_params(jcfg, seed) for seed in (0, 1, 2)]
    jp = jax.tree.map(lambda *xs: np.stack(xs), *reps)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 2, 16, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jax.vmap(lambda pp, xx: jmoe.apply_moe(pp, jcfg, xx, CTX))(p, x)
        return jnp.sum(y * g) + jnp.sum(aux * jnp.arange(1.0, 4.0)), (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    p = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(), jp)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(p, cfg, xt)
    ((y * torch.from_numpy(g)).sum() + (aux * torch.arange(1.0, 4.0)).sum()).backward()
    assert aux.shape == (3,)
    for r in range(3):
        one = {k: v[r].detach() for k, v in p.items()}
        assert _check_routing(reps[r], one, x[r], cfg.num_experts_per_token)[0] == 0
        assert _drops(cfg, one, x[r]) > 0
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(jaux), atol=AUX_ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=ATOL, rtol=GRAD_RTOL)
    for name in p:
        np.testing.assert_allclose(p[name].grad.numpy(), np.asarray(jgp[name]), atol=ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    # folding the replicas into the token axis would route differently
    folded = moe.capacity(3 * 32, cfg.num_experts_per_token, cfg.num_experts, 0.5)
    assert folded != moe.capacity(32, cfg.num_experts_per_token, cfg.num_experts, 0.5)


def test_ties_take_the_lower_expert_first():
    """Equal probabilities (a zero router) pick experts 0..k−1 in order, as
    ``jax.lax.top_k`` does; the output and aux match the reference."""
    jcfg, cfg = _configs("granite-moe-1b-a400m")
    jp = _jax_params(jcfg, 0)
    jp["router"] = np.zeros_like(jp["router"])
    x = np.random.default_rng(2).normal(size=(1, 8, cfg.d_model)).astype(np.float32)
    p = tree_map(lambda a: torch.from_numpy(a.copy()), jp)
    _, top_p, top_e = moe.route(p["router"][None], torch.from_numpy(x).reshape(1, 8, -1), 2)
    assert top_e[0].tolist() == [[0, 1]] * 8 and torch.all(top_p == 0.5)
    assert _check_routing(jp, p, x, 2)[0] == 0
    jy, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x), CTX)
    y, aux = moe.apply_moe(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=AUX_ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_activation_variants_match_jax(variant):
    """The three expert activations (granite and qwen3-moe use swiglu):
    gated variants carry ``w_gate``, gelu does not."""
    jcfg, cfg = _configs("granite-moe-1b-a400m", mlp_variant=variant)
    jp = _jax_params(jcfg, 3)
    assert ("w_gate" in jp) == (variant != "gelu")
    x = np.random.default_rng(3).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x), CTX)
    y, aux = moe.apply_moe(tree_map(lambda a: torch.from_numpy(a.copy()), jp), cfg,
                           torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=AUX_ATOL, rtol=0)


def test_router_stays_fp32_in_a_bf16_model():
    cfg = registry.get_config("granite-moe-1b-a400m").reduced()
    assert cfg.dtype == "bfloat16"
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert p["router"].dtype == torch.float32
    assert all(p[k].dtype == torch.bfloat16 for k in ("w_in", "w_gate", "w_out"))
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    y, aux = moe.apply_moe(p, cfg, x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert len(tree_leaves(p)) == 4
