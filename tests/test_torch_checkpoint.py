"""The port's checkpoints against the JAX package's, on the CPU.

* The port's own MessagePack coder gives the bytes ``msgpack.packb`` gives
  (the test imports msgpack; the port does not).
* A checkpoint written by either package restores in the other with equal
  leaves and structure (bf16, 0-d, None, tuple and list nodes included).
* Saves are atomic and ``keep`` prunes as in ``tests/test_data_checkpoint.py``.
* Resume: in the port it reproduces the uninterrupted run exactly; from a
  JAX checkpoint it follows JAX's uninterrupted run within 1e-4 relative
  (the two packages sum in other orders), and JAX resumes a port checkpoint.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.launch.train import run_training as jax_run_training
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.checkpoint import ckpt, msgpack_subset
from repro_torch.comm import CommConfig
from repro_torch.launch import train as train_cli
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.train import adapters
from repro_torch.tree import tree_leaves

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)
KW = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=32, inner_lr=3e-3,
          inner_steps=4, eval_every=0, total_steps=12)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def _mixed_tree():
    """bf16, fp32, int and bool leaves, a 0-d leaf, None, a tuple and a list
    (dict keys sorted, as ``jax.tree.map`` rebuilds them)."""
    rng = np.random.default_rng(0)
    return {
        "empty": np.zeros((0, 2), np.float32),
        "opt": ({"count": np.int32(7)}, None),
        "seq": [np.arange(5, dtype=np.int64), np.array([True, False]),
                np.array([0, 11], dtype=np.uint32)],
        "theta": {"b": rng.normal(size=(3,)).astype(np.float32),
                  "w": rng.normal(size=(3, 4)).astype(ml_dtypes.bfloat16)},
    }


def _assert_same_tree(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    elif want is None:
        assert got is None
    else:
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# Format
# ---------------------------------------------------------------------------


def test_msgpack_subset_bytes_equal_msgpack():
    manifest = ckpt._encode_tree(_mixed_tree(), [])
    objs = [manifest, [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
                       -2**15 - 1, -2**31 - 1, 2**64 - 1, -2**63],
            {"s" * 31: "t" * 32, "u" * 300: b"\x00" * 70000}, [True, False, None, 1.5, -0.25],
            list(range(16)), {str(i): [] for i in range(16)}]
    for obj in objs:
        data = msgpack_subset.packb(obj)
        assert data == msgpack.packb(obj)
        hexed = lambda b: bytes(b).hex()   # bin: a memoryview in the port, bytes in msgpack
        assert json.dumps(msgpack_subset.unpackb(data), default=hexed) == json.dumps(
            msgpack.unpackb(data, strict_map_key=False), default=hexed)


def test_jax_checkpoint_restores_in_port(tmp_path):
    tree = _mixed_tree()
    jckpt.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree))
    back = ckpt.restore(str(tmp_path))
    _assert_same_tree(back, tree)
    assert back["theta"]["w"].dtype == torch.bfloat16 and back["opt"][0]["count"].shape == ()


def test_port_checkpoint_restores_in_jax_byte_for_byte(tmp_path):
    """The port writes the very bytes the JAX package writes for one tree."""
    tree = _mixed_tree()
    port = ckpt.save(str(tmp_path / "port"), 5, jax.tree.map(
        lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        if x.dtype == ml_dtypes.bfloat16 else x, tree))
    jax_dir = jckpt.save(str(tmp_path / "jax"), 5, tree)
    for name in ("manifest.msgpack", "arrays.msgpack"):
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    _assert_same_tree(jckpt.restore(str(tmp_path / "port"), 5), tree)


def test_leaf_over_the_bin_limit_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(msgpack_subset, "BIN_MAX", 15)
    with pytest.raises(ValueError, match="bin limit"):
        ckpt.save(str(tmp_path), 1, {"w": np.zeros(4, np.float32)})
    assert ckpt.latest_step(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# Save behaviour (as tests/test_data_checkpoint.py holds the JAX package)
# ---------------------------------------------------------------------------


def _steps_on_disk(d):
    return [s for s, _ in ckpt._steps(str(d))]


def test_save_is_atomic_and_sweeps_leftovers(tmp_path, monkeypatch):
    tree = {"w": np.arange(4.0)}
    ckpt.save(str(tmp_path), 1, tree)

    def crash(obj, write):
        raise OSError("killed mid-save")

    monkeypatch.setattr(msgpack_subset, "pack_to", crash)
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path), 2, tree)
    assert _steps_on_disk(tmp_path) == [1] and ckpt.latest_step(str(tmp_path)) == 1
    assert os.path.isdir(tmp_path / "step_00000002.tmp")
    monkeypatch.undo()
    ckpt.save(str(tmp_path), 3, {"w": np.arange(3.0)})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    ckpt.save(str(tmp_path), 3, tree)   # re-saving a step replaces it
    np.testing.assert_array_equal(ckpt.restore(str(tmp_path), 3)["w"], np.arange(4.0))


def test_keep_prunes_oldest_and_ignores_foreign_entries(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "notes"))
    for name in ("events.jsonl", "step_final.txt"):
        with open(os.path.join(d, name), "w") as f:
            f.write("x\n")
    for step in (2, 5, 8, 11, 14):
        ckpt.save(d, step, {"w": np.arange(4.0)}, keep=3)
    assert _steps_on_disk(d) == [8, 11, 14] and ckpt.latest_step(d) == 14
    assert all(os.path.exists(os.path.join(d, n)) for n in ("notes", "events.jsonl", "step_final.txt"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, 2)
    for step in (15, 16):
        ckpt.save(d, step, {"w": np.zeros(2)})   # keep=None retains everything
    assert _steps_on_disk(d) == [8, 11, 14, 15, 16]
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# Training state and resume
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_weights(monkeypatch):
    """Both packages start from the JAX initial weights."""
    cfg = ModelConfig(**TINY)
    params = jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(0),
                                                               JModelConfig(**TINY))))
    monkeypatch.setattr(adapters.GossipProgram, "initial_params",
                        lambda self: convert.params_from_jax_numpy(params, cfg))
    return cfg


def test_resume_in_port_matches_uninterrupted(tmp_path, jax_weights):
    cfg, d = jax_weights, str(tmp_path / "ck")
    log = tmp_path / "events.jsonl"
    full = train_cli.run_training(cfg, device="cpu", steps=12, codec="int8", **KW)
    first = train_cli.run_training(cfg, device="cpu", steps=6, codec="int8", ckpt_dir=d,
                                   ckpt_every=3, **KW)
    assert first["start_step"] == 0 and _steps_on_disk(d) == [3, 6]
    cont = train_cli.run_training(cfg, device="cpu", steps=12, codec="int8", ckpt_dir=d,
                                  resume=True, log_jsonl=str(log), **KW)
    assert cont["start_step"] == 6 and cont["steps_run"] == 6
    assert cont["losses"] == full["losses"][6:]
    for a, b in zip(tree_leaves(cont["state"].theta), tree_leaves(full["state"].theta)):
        assert torch.equal(a, b)
    events = [json.loads(line) for line in open(log)]
    assert events[0]["event"] == "run_start" and events[0]["resumed"] and events[0]["start_step"] == 6
    assert [e["step"] for e in events if e["event"] == "ckpt"] == [12]
    assert events[-1]["start_step"] == 6 and events[-1]["steps_run"] == 6


def test_resume_from_jax_and_jax_from_port(tmp_path, jax_weights):
    cfg = jax_weights
    jcfg = JModelConfig(**TINY)
    jfull = jax_run_training(jcfg, steps=12, impl="jnp", **KW)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_run_training(jcfg, steps=6, ckpt_dir=jdir, impl="jnp", **KW)
    cont = train_cli.run_training(cfg, device="cpu", steps=12, ckpt_dir=jdir, resume=True, **KW)
    assert cont["start_step"] == 6
    np.testing.assert_allclose(cont["losses"], jfull["losses"][6:], rtol=1e-4, atol=0)
    np.testing.assert_allclose(cont["final_weight_std"], jfull["final_weight_std"], rtol=1e-3)

    train_cli.run_training(cfg, device="cpu", steps=6, ckpt_dir=pdir, **KW)
    restored, jax_saved = jckpt.restore(pdir), jckpt.restore(jdir)
    assert jax.tree.structure(restored) == jax.tree.structure(jax_saved)   # state_pytree + loop
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jax_saved)):
        assert a.shape == b.shape and a.dtype == b.dtype
    _assert_same_tree(restored, ckpt.restore(pdir))
    jcont = jax_run_training(jcfg, steps=12, ckpt_dir=pdir, resume=True, impl="jnp", **KW)
    assert jcont["start_step"] == 6
    np.testing.assert_allclose(jcont["losses"], jfull["losses"][6:], rtol=1e-4, atol=0)


def test_state_pytree_is_the_jax_layout(jax_weights):
    cfg = jax_weights
    program = adapters.GossipProgram(cfg, train_cli.method_config("noloco", inner_lr=1e-3,
                                                                  total_steps=4), replicas=3,
                                     device="cpu")
    tree = program.state_pytree(program.init_state(None))
    assert list(tree) == ["theta", "opt", "outer", "inner_step", "membership"]
    assert tree["outer"]["step"].dtype == np.int32 and tree["inner_step"].dtype == np.int32
    assert tree["opt"]["count"].dtype == np.int32 and tree["opt"]["count"].shape == (3,)
    assert tree["membership"]["mask"].all() and int(tree["membership"]["epoch"]) == 0
    assert (tree["membership"]["partition"] == -1).all()
    assert list(tree["theta"]) == sorted(tree["theta"])


@pytest.mark.parametrize("change", ["dropped", "partition", "stream"])
def test_loading_elastic_or_streaming_state_raises(jax_weights, change):
    """Each loads since its feature was ported: a dropped replica and a
    partition restore what the JAX package's ``ElasticContext.
    load_state_dict`` makes of the same tree; a ``stream`` subtree (the
    pre-send tables and the prefetched φ) restores into a streaming
    program what JAX's ``GossipProgram.load_state_pytree`` makes of it,
    ``state_pytree`` writes it back, and a tree without one resets it."""
    from repro.comm import CommConfig as JCommConfig
    from repro.core.elastic import ElasticContext as JElasticContext
    from repro.launch.train import method_config as jmethod_config
    from repro.train.adapters import GossipProgram as JGossipProgram

    cfg = jax_weights
    if change == "stream":
        comm = dict(streams=2, overlap=True)
        kw = dict(inner_lr=1e-3, total_steps=4, inner_steps=2)
        program = adapters.GossipProgram(
            cfg, train_cli.method_config("noloco", comm=CommConfig(**comm), **kw), replicas=3,
            device="cpu")
        jprogram = JGossipProgram(JModelConfig(**TINY), jmethod_config(
            "noloco", comm=JCommConfig(**comm), **kw), replicas=3)
        state = program.init_state(None)
        tree = program.state_pytree(state)
        assert tree["stream"]["pre_epoch"].tolist() == [-1, -1] and "phi_pre" not in tree["stream"]
        phi_pre = jax.tree.map(lambda x: x + np.float32(0.5), tree["outer"]["phi"])
        tree["stream"] = {"pre_partner": np.array([[1, 0, 2], [2, 1, 0]], np.int64),
                          "pre_epoch": np.array([0, -1], np.int64), "phi_pre": phi_pre}
        restored = program.load_state_pytree(state, tree)
        jprogram.load_state_pytree(None, tree)
        np.testing.assert_array_equal(program._pre_partner, jprogram._pre_partner)
        np.testing.assert_array_equal(program._pre_epoch, jprogram._pre_epoch)
        got = program.state_pytree(restored)["stream"]
        assert jax.tree.structure(got) == jax.tree.structure(
            {**tree["stream"], "phi_pre": jprogram._phi_pre})
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves({**tree["stream"],
                                                               "phi_pre": jprogram._phi_pre})):
            np.testing.assert_array_equal(a, np.asarray(b))
        del tree["stream"]
        program.load_state_pytree(state, tree)
        jprogram.load_state_pytree(None, tree)
        assert program._phi_pre is None and jprogram._phi_pre is None
        np.testing.assert_array_equal(program._pre_epoch, jprogram._pre_epoch)
        assert program._pre_epoch.tolist() == [-1, -1]
        return
    program = adapters.GossipProgram(cfg, train_cli.method_config("noloco", inner_lr=1e-3,
                                                                  total_steps=4), replicas=3,
                                     device="cpu")
    state = program.init_state(None)
    tree = program.state_pytree(state)
    if change == "dropped":
        tree["membership"]["mask"] = np.array([True, False, True])
        tree["membership"]["epoch"] = np.int64(1)
    else:
        tree["membership"]["partition"] = np.array([0, 0, 1])
    restored = program.load_state_pytree(state, tree)
    want = JElasticContext(world=3)
    want.load_state_dict(tree["membership"])
    assert program.membership.mask == want.membership.mask
    assert program.membership.epoch == want.membership.epoch
    assert program.partition == want.partition
    assert program.partition == (None if change == "dropped" else ((0, 1), (2,)))
    for a, b in zip(tree_leaves(restored.theta), tree_leaves(state.theta)):
        assert torch.equal(a, b)
    for k, v in program.state_pytree(restored)["membership"].items():
        np.testing.assert_array_equal(v, tree["membership"][k])
