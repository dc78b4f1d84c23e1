"""The port's serve CLI takes the JAX CLI's documented command lines.

``repro.launch.serve`` documents ``--arch qwen3-0.6b --reduced`` (a
``store_true`` flag whose default is already True); the port's parser
takes it and resolves the same reduced config, and ``--full`` still
resolves the published one.  Config fields are compared exactly.
"""
import dataclasses

import pytest

from repro.configs import registry as jax_registry
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_cli

FIELDS = ("name", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "vocab_size",
          "dtype")


def _fields(cfg):
    return {f: getattr(cfg, f) for f in FIELDS if f in {x.name for x in dataclasses.fields(cfg)}}


@pytest.mark.parametrize("argv", [["--arch", "qwen3-0.6b", "--reduced"], ["--arch", "qwen3-0.6b"]])
def test_serve_parser_takes_the_reference_reduced_line(argv):
    args = serve_cli.build_parser().parse_args(argv)
    assert args.full is False
    cfg = serve_cli.resolve_config(args)
    assert cfg == registry.get_config("qwen3-0.6b").reduced(dtype="float32", remat=False)
    jax_cfg = jax_registry.get_config("qwen3-0.6b").reduced(dtype="float32", remat=False)
    assert _fields(cfg) == _fields(jax_cfg) and cfg.num_layers == 2


def test_serve_parser_full_gives_the_published_config():
    args = serve_cli.build_parser().parse_args(["--arch", "qwen3-0.6b", "--full"])
    cfg = serve_cli.resolve_config(args)
    assert cfg == registry.get_config("qwen3-0.6b")
    assert _fields(cfg) == _fields(jax_registry.get_config("qwen3-0.6b"))
    assert cfg.num_layers == 28 and cfg.dtype == "bfloat16"


def test_serve_parser_rejects_reduced_with_full():
    with pytest.raises(SystemExit):
        serve_cli.build_parser().parse_args(["--reduced", "--full"])


def test_serve_cli_runs_the_reduced_line_on_the_cpu():
    summary = serve_cli.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                              "--requests", "2", "--prompt-lens", "4,6", "--gen-lens", "3",
                              "--pages", "16", "--page-size", "4", "--prefill-chunk", "4"])
    assert summary["arch"] == "qwen3-0.6b" and summary["device"] == "cpu"
