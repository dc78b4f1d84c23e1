from repro_torch.data.loader import LoaderConfig, eval_batches, shard_iterator
from repro_torch.data.synthetic import SyntheticLM

__all__ = ["LoaderConfig", "SyntheticLM", "eval_batches", "shard_iterator"]
