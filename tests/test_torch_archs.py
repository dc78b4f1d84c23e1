"""Every architecture of the reference's registry in the port: registry,
parameter structure and conversion of each, and one loss-and-gradient
evaluation of each decoder-only one against the JAX package on the CPU
(the encoder-decoder and vision models' losses are held in
``tests/test_torch_encdec.py`` and ``tests/test_torch_vision.py``).

Configs are ``reduced(dtype="float32", remat=False)``; weights come from the
JAX initialiser and are converted.  Tolerances: the loss (LM + MoE aux)
within 1e-5 absolute, the auxiliary loss within 1e-6, gradients within
1e-5 absolute plus 1e-5 relative (fp32 sums in another order; the largest
gradients, of embeddings and routers, reach ~10).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.models.common import values_of
from repro.parallel.sharding import ShardCtx
from repro_torch.configs import registry
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

FRONTEND = ["whisper-base", "internvl2-76b"]
DECODER_ONLY = [a for a in jax_registry.ASSIGNED if a not in FRONTEND]
PAPER = ["paper-small-125m", "paper-medium-1.3b", "paper-large-6.8b"]
ARCHS = DECODER_ONLY + PAPER
EVERY = list(jax_registry.ASSIGNED) + PAPER
NEW = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "gemma-2b", "stablelm-1.6b", "minitron-8b"]
LOSS_ATOL, AUX_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5, 1e-5


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
    kw = dict(kw, dtype=kw.get("dtype", "float32"), remat=False)
    return jax_registry.get_config(arch).reduced(**kw), registry.get_config(arch).reduced(**kw)


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(seed), jcfg)))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return None if tree is None else tuple(tree.shape)


def test_decoder_only_list_is_the_reference_minus_encdec_and_vision():
    assert len(DECODER_ONLY) == 8 and set(NEW) <= set(DECODER_ONLY)


@pytest.mark.parametrize("arch", EVERY)
def test_published_config_is_the_reference(arch):
    """Every published field of the port's config equals the reference's
    (the port's ModelConfig lacks only the JAX tracing fields)."""
    want = dataclasses.asdict(jax_registry.get_config(arch))
    got = dataclasses.asdict(registry.get_config(arch))
    assert {k: want[k] for k in got} == got


@pytest.mark.parametrize("arch", FRONTEND)
def test_encdec_and_vision_name_item_8d(arch):
    """The two archs of ROADMAP item 8d resolve, with the reference's
    fields, and the registry holds every arch of the reference's."""
    cfg = registry.get_config(arch)
    want = dataclasses.asdict(jax_registry.get_config(arch))
    assert {k: want[k] for k in dataclasses.asdict(cfg)} == dataclasses.asdict(cfg)
    assert cfg.is_encoder_decoder == (arch == "whisper-base")
    assert cfg.frontend == ("audio" if arch == "whisper-base" else "vision")
    assert set(registry.ARCHS) == set(jax_registry.ARCHS)


@pytest.mark.parametrize("arch", EVERY)
def test_init_structure_and_dtypes_match_jax(arch):
    """The port's init at the model's own dtype (bf16) has the reference's
    tree, shapes and leaf dtypes (fp32 norms, mixers' rates and routers)."""
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    want = jax.eval_shape(lambda: values_of(JM.init_params(jax.random.PRNGKey(0), jcfg)))
    got = M.init_params(torch.Generator().manual_seed(0), cfg)
    assert _shapes(got) == _shapes(want) == convert.expected_shapes(cfg)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


@pytest.mark.parametrize("arch", NEW + FRONTEND)
def test_convert_round_trips_bf16_tree(arch):
    """A bf16 JAX tree converts leaf for leaf, fp32 leaves staying fp32,
    and the port's host view of it is the same tree bit for bit."""
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    tree = _jax_params(jcfg)
    params = convert.params_from_jax_numpy(tree, cfg)
    for got, want in zip(tree_leaves(params), jax.tree.leaves(tree), strict=True):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        back = convert.to_host(got)
        back = back.view(torch.int16).numpy() if isinstance(back, torch.Tensor) else back
        np.testing.assert_array_equal(back, want.view(np.int16) if want.dtype.name == "bfloat16"
                                      else want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg = _configs(arch)
    params = _jax_params(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jb, ShardCtx.local()), has_aux=True
    )(jax.tree.map(jnp.asarray, params))
    tp = tree_map(lambda t: t.requires_grad_(), convert.params_from_jax_numpy(params, cfg))
    loss, parts = M.loss_fn(tp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_ATOL
    assert abs(parts["aux_loss"].item() - float(jparts["aux_loss"])) <= AUX_ATOL
    assert (parts["aux_loss"].item() > 0) == (cfg.arch_type == "moe")
    for t, w in zip(tree_leaves(tp), jax.tree.leaves(jgrads), strict=True):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL)
