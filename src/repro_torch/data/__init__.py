from repro_torch.data.loader import LoaderConfig, TokenFileSource, eval_batches, shard_iterator
from repro_torch.data.packing import pack_documents
from repro_torch.data.synthetic import SyntheticLM

__all__ = ["LoaderConfig", "SyntheticLM", "TokenFileSource", "eval_batches", "pack_documents",
           "shard_iterator"]
