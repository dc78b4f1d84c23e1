"""The port's CLIs take the JAX CLIs' documented command lines.

``repro.launch.serve`` documents ``--arch qwen3-0.6b --reduced`` (a
``store_true`` flag whose default is already True); the port's parser
takes it and resolves the same reduced config, and ``--full`` still
resolves the published one.  Config fields are compared exactly.
``repro_torch.launch.train_elastic`` takes the reference's flags, defaults
to ``cuda`` and raises without it, and runs a fault plan on the CPU when
asked.
"""
import argparse
import dataclasses
import json

import pytest
import torch

from repro.configs import registry as jax_registry
from repro.launch import train_elastic as jax_elastic_cli
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train_elastic as elastic_cli
from repro_torch.models.config import ModelConfig
from repro_torch.sim import FaultPlan

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


def test_train_elastic_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert elastic_cli.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic_cli.main(["--reduced", "--steps", "1"])
    tiny = ModelConfig(num_layers=1, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                       vocab_size=64, dtype="float32", remat=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic_cli.run_elastic_training(tiny, FaultPlan(), steps=1)


def test_train_elastic_takes_the_reference_flags():
    """Every flag of the reference's parser (bar its kernel-dispatch flags:
    the port's kernels follow the device) parses to the same default."""
    ref = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        ref.update(vars(parse(self, [])))
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            jax_elastic_cli.main()
    ours = vars(elastic_cli.build_parser().parse_args([]))
    for k in ("impl", "interpret"):
        ref.pop(k)
    assert set(ours) == set(ref) | {"device"}
    assert {k: ours[k] for k in ref} == ref


def test_train_elastic_cli_runs_a_fault_plan_on_the_cpu(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    FaultPlan.build([{"kind": "drop", "round": 1, "replicas": [2]},
                     {"kind": "straggle", "round": 2, "replicas": [0]},
                     {"kind": "rejoin", "round": 3, "replicas": [2]}]).save(str(plan))
    out, log = tmp_path / "res.json", tmp_path / "events.jsonl"
    summary = elastic_cli.main(["--device", "cpu", "--reduced", "--replicas", "4", "--batch", "1",
                                "--seq", "16", "--steps", "8", "--inner-steps", "2",
                                "--eval-every", "4", "--fault-plan", str(plan),
                                "--log-jsonl", str(log), "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["device"] == "cpu" and summary["outer_syncs"] == 4
    assert summary["membership"] == {"epoch": 2, "active": [0, 1, 2, 3]}
    assert summary["max_staleness"] == 0 and summary["blocked_syncs"] == 1
    events = [json.loads(line) for line in open(log)]
    assert [e["epoch"] for e in events if e["event"] == "membership"] == [1, 2]
    assert len([e for e in events if e["event"] == "outer_async"]) == 4
    rounds = json.loads(out.read_text())["rounds"]
    assert [r["absent"] for r in rounds] == [[], [], [0], []]
    # streaming outer steps, which raised until they were ported: two streams
    # with the overlap, m 2, every step from 2 a stream sync
    streamed_log = tmp_path / "streamed.jsonl"
    streamed = elastic_cli.main(["--device", "cpu", "--reduced", "--replicas", "4", "--batch", "1",
                                 "--seq", "16", "--steps", "6", "--inner-steps", "2",
                                 "--stream-count", "2", "--log-jsonl", str(streamed_log)])
    assert streamed["stream_count"] == 2 and streamed["outer_syncs"] == 5
    assert 0.0 < streamed["blocking_fraction"] < 1.0
    syncs = [e for e in map(json.loads, open(streamed_log)) if e["event"] == "stream_sync"]
    assert [e["stream"] for e in syncs] == [0, 1, 0, 1, 0]
    assert [e["blocked"] for e in syncs] == [True, True, False, False, False]
