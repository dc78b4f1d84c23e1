"""Package rules of the PyTorch port.

* Nothing under ``src/repro_torch`` nor ``chip_smoke.py`` imports JAX, the
  JAX package, ``msgpack`` or ``ml_dtypes`` (neither is known to be on the
  card's machine): checked by parsing every source and by importing every
  module in a fresh interpreter.
* Entry points run on CUDA unless asked for the CPU, and raise when there
  is no GPU rather than dropping to the CPU.
* A tensor that is not on the CPU never reaches a plain version: the ops
  launch the kernel or raise.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import types

from repro_torch.kernels import (
    build, decode_update, flash_attention, noloco_update, ops, paged_attention, ref, rglru_scan,
    ssd_scan,
)
from repro_torch.launch import serve, train

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "msgpack", "ml_dtypes"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        bad = FORBIDDEN.intersection(roots)
        assert not bad, f"{path.name}:{node.lineno} imports {sorted(bad)}"


def test_importing_every_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(modules) >= 20


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert train.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced"])


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert serve.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])


def test_promote_and_gossip_program_default_to_cuda(monkeypatch, tmp_path):
    from repro_torch.configs import registry
    from repro_torch.serve import promote
    from repro_torch.train import adapters

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("paper-small-125m").reduced(dtype="float32", remat=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        promote(str(tmp_path), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adapters.GossipProgram(cfg, train.method_config("noloco", inner_lr=1e-3, total_steps=4),
                               replicas=2)


def test_serve_cli_on_cpu(capsys):
    summary = serve.main(["--device", "cpu", "--requests", "3", "--max-batch", "2",
                          "--pages", "16", "--page-size", "4", "--prompt-lens", "4,9",
                          "--gen-lens", "3,5", "--prefill-chunk", "4", "--verify"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["event"] == "run_end" and summary["requests"] == 3
    assert summary["gen_tokens"] == 3 + 5 + 3 and summary["parity"] is True
    assert summary["device"] == "cpu"


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: lets this box show where a
    CUDA tensor would go."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Launched(Exception):
    pass


def _args(chunk, wrap):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 3, 4, 8) if chunk else (2, 4, 8), generator=g)
    pools = [torch.randn(5, 4, 2, 8, generator=g) for _ in range(2)]
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pos = torch.tensor([3, 1], dtype=torch.int32)
    return [wrap(t) for t in (q, *pools, tables, pos)]


@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch, chunk):
    def plain_called(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    def library():
        raise _Launched

    monkeypatch.setattr(ref, "torch_paged_attention", plain_called)
    monkeypatch.setattr(ref, "torch_paged_chunk_attention", plain_called)
    monkeypatch.setattr(paged_attention, "library", library)
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    kernel = paged_attention.paged_chunk_attention if chunk else paged_attention.paged_decode_attention
    before = kernel.launches
    with pytest.raises(_Launched):   # a CUDA tensor goes to the kernel
        op(*_args(chunk, lambda t: t.as_subclass(_FakeCuda)))
    with pytest.raises(ValueError, match="CUDA tensor"):   # any other device raises
        op(*_args(chunk, lambda t: t.to("meta")))
    assert kernel.launches == before


def _flash_args(wrap):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 4, 8, generator=g)
    k, v = (torch.randn(2, 5, 2, 8, generator=g) for _ in range(2))
    return [wrap(t) for t in (q, k, v)]


def _plain_called(*a, **k):
    raise AssertionError("plain version called for a non-CPU tensor")


def _launched():
    raise _Launched


def test_flash_forward_never_reaches_the_plain_version(monkeypatch):
    monkeypatch.setattr(ref, "torch_flash_attention", _plain_called)
    monkeypatch.setattr(ref, "torch_flash_attention_fwd", _plain_called)
    monkeypatch.setattr(flash_attention, "library", _launched)
    before = flash_attention.flash_attention_fwd.launches
    with pytest.raises(_Launched):   # a CUDA tensor goes to the kernel
        ops.flash_attention(*_flash_args(lambda t: t.as_subclass(_FakeCuda)))
    with pytest.raises(ValueError, match="CUDA tensor"):   # any other device raises
        ops.flash_attention(*_flash_args(lambda t: t.to("meta")))
    assert flash_attention.flash_attention_fwd.launches == before


def test_flash_backward_never_reaches_the_plain_version(monkeypatch):
    """The autograd function's backward launches the backward kernel."""
    monkeypatch.setattr(ref, "torch_flash_attention_bwd", _plain_called)
    monkeypatch.setattr(flash_attention, "library", _launched)
    q, k, v = _flash_args(lambda t: t.as_subclass(_FakeCuda))
    lse = torch.zeros(2, 4, 5).as_subclass(_FakeCuda)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, q, lse), mode="causal", window=0)
    before = flash_attention.flash_attention_bwd.launches
    with pytest.raises(_Launched):
        flash_attention.FlashAttention.backward(ctx, q)
    meta = [t.as_subclass(torch.Tensor).to("meta") for t in (q, k, v, q, lse)]
    ctx.saved_tensors = meta
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.FlashAttention.backward(ctx, meta[0])
    assert flash_attention.flash_attention_bwd.launches == before


def test_outer_update_never_reaches_the_plain_version(monkeypatch):
    monkeypatch.setattr(ref, "torch_noloco_update", _plain_called)
    monkeypatch.setattr(noloco_update, "library", _launched)
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9)

    def trees(wrap):
        return [{"w": wrap(torch.randn(3, 4)), "b": [wrap(torch.randn(3))]} for _ in range(4)]

    before = noloco_update.noloco_update.launches
    with pytest.raises(_Launched):
        ops.noloco_update_pytree(*trees(lambda t: t.as_subclass(_FakeCuda)), **coef)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.noloco_update_pytree(*trees(lambda t: t.to("meta")), **coef)
    assert noloco_update.noloco_update.launches == before


def test_build_starts_every_nvcc_before_waiting(monkeypatch, tmp_path):
    """One nvcc per source, all started before the first is waited on."""
    events = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            events.append(("start", pathlib.Path(cmd[-1]).stem))

        def communicate(self):
            events.append(("wait", None))
            pathlib.Path(self.out).write_bytes(b"")
            return "ptxas info", None

    monkeypatch.setattr(build.shutil, "which", lambda name: "/bin/nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    build.build_all()
    names = build.sources()
    assert set(names) >= {"flash_attention", "noloco_update", "paged_attention"}
    assert events[:len(names)] == [("start", n) for n in names]
    assert all(build.library_path(n).exists() for n in names)
    build.build_all()   # everything built: nothing starts
    assert len(events) == 2 * len(names)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", tmp_path / "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load.__wrapped__("paged_attention")
    assert not (tmp_path / "build").exists()


def test_library_path_follows_the_source_hash(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    src.write_text("// two\n")
    assert build.library_path("k") != first
    assert first.parent == build.BUILD_DIR and first.suffix == ".so"


def _recurrent_cases():
    """(op call, wrapper module, plain-version names) of the four recurrent ops."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.rand(shape, generator=g)
    return {
        "ssd_chunk": (lambda w: ops.ssd_chunk(*map(w, (r(1, 6, 2, 4), r(1, 6, 2), -r(2), r(1, 6, 3),
                                                        r(1, 6, 3))), chunk=4),
                      ssd_scan, ssd_scan.ssd_chunk, ["torch_ssd_chunk_intra"]),
        "rglru_scan": (lambda w: ops.rglru_scan(w(r(2, 5, 3)), w(r(2, 5, 3))),
                       rglru_scan, rglru_scan.rglru_scan, ["torch_rglru_scan"]),
        "rglru_decode": (lambda w: ops.rglru_decode(*map(w, (r(2, 3), r(2, 3), r(2, 3)))),
                         decode_update, decode_update.rglru_decode, ["torch_rglru_decode"]),
        "ssd_decode": (lambda w: ops.ssd_decode(*map(w, (r(2, 2, 4, 3), r(2, 2), -r(2), r(2, 3),
                                                         r(2, 3), r(2, 2, 4)))),
                       decode_update, decode_update.ssd_decode, ["torch_ssd_decode"]),
    }


@pytest.mark.parametrize("name", ["ssd_chunk", "rglru_scan", "rglru_decode", "ssd_decode"])
def test_recurrent_ops_never_reach_the_plain_version(monkeypatch, name):
    call, module, kernel, plains = _recurrent_cases()[name]
    for plain in plains:
        monkeypatch.setattr(ref, plain, _plain_called)
    monkeypatch.setattr(module, "library", _launched)
    before = kernel.launches
    with pytest.raises(_Launched):   # a CUDA tensor goes to the kernel
        call(lambda t: t.as_subclass(_FakeCuda))
    with pytest.raises(ValueError, match="CUDA tensor"):   # any other device raises
        call(lambda t: t.to("meta"))
    assert kernel.launches == before


@pytest.mark.parametrize("name", ["ssd_chunk", "ssd_decode"])
def test_ssd_wrappers_reject_cpu_tensors_before_they_build(monkeypatch, name):
    """The SSD kernels' wrappers, called directly with CPU tensors, raise
    before they reach the library (whose build needs nvcc)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.rand(shape, generator=g)
    if name == "ssd_chunk":
        module, call = ssd_scan, lambda: ssd_scan.ssd_chunk(r(1, 1, 4, 2, 8), r(1, 1, 4, 2), -r(2),
                                                            r(1, 1, 4, 8), r(1, 1, 4, 8))
    else:
        module, call = decode_update, lambda: decode_update.ssd_decode(r(2, 6, 8), r(2, 6), r(2, 6),
                                                                       r(2, 8), r(2, 8))
    monkeypatch.setattr(module, "library", _launched)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


@pytest.mark.parametrize("name", ["ssd_chunk", "rglru_scan"])
def test_recurrent_scan_backward_reaches_the_kernel(monkeypatch, name):
    """The scans' autograd functions backpropagate through the backward
    kernels: with tensors that report a CUDA device the backward reaches the
    kernel wrapper's library, never the plain version; on any other device
    the wrapper raises."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.rand(shape, generator=g)
    if name == "ssd_chunk":
        fn, module, kernel = ops._SSDChunkIntra, ssd_scan, ssd_scan.ssd_chunk_bwd
        saved = (r(1, 2, 4, 2, 8), r(1, 2, 4, 2), -r(2), r(1, 2, 4, 3), r(1, 2, 4, 3))
        grads = (r(1, 2, 4, 2, 8), r(1, 2, 2, 3, 8))
        monkeypatch.setattr(ref, "torch_ssd_chunk_intra_bwd", _plain_called)
    else:
        fn, module, kernel = ops._RGLRUScan, rglru_scan, rglru_scan.rglru_scan_bwd
        saved, grads = (r(2, 5, 3), r(2, 5, 3)), (r(2, 5, 3),)
        monkeypatch.setattr(ref, "torch_rglru_scan_bwd", _plain_called)
    monkeypatch.setattr(module, "library", _launched)
    before = kernel.launches
    ctx = types.SimpleNamespace(saved_tensors=tuple(t.as_subclass(_FakeCuda) for t in saved))
    with pytest.raises(_Launched):
        fn.backward(ctx, *(t.as_subclass(_FakeCuda) for t in grads))
    ctx.saved_tensors = tuple(t.to("meta") for t in saved)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn.backward(ctx, *(t.to("meta") for t in grads))
    assert kernel.launches == before
