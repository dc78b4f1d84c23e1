"""The routed pipeline (paper §3.1): stage replicas with random routing
between them and the per-stage gossip outer step (the port of
``repro/pipeline``)."""

from repro_torch.pipeline.runner import PipelineTrainer, split_stages

__all__ = ["PipelineTrainer", "split_stages"]
