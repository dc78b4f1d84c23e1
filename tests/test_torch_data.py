"""The port's token-file source and document packing against
``repro.data`` on the CPU: the same windows of a pretokenized int32 file
(written here, under ``tmp_path``), the same packed rows and loss mask.
Integer data: everything is held ``array_equal``."""
import numpy as np
import pytest

from repro.data import loader as jloader
from repro.data import packing as jpacking
from repro_torch.data import LoaderConfig, TokenFileSource, eval_batches, pack_documents, shard_iterator


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, size=5_000).astype(np.int32).tofile(path)
    return str(path)


@pytest.mark.parametrize("seed,replicas,batch,seq,start", [(0, 4, 2, 32, 0), (777, 3, 1, 17, 5),
                                                           (1, 2, 3, 200, 2)])
def test_token_file_windows_match_jax(token_file, seed, replicas, batch, seq, start):
    """Same rows from the same file, steps past its end wrapping as the
    reference's cursor does; the eval batches too."""
    kw = dict(vocab_size=1000, seq_len=seq, per_replica_batch=batch, replicas=replicas, seed=seed)
    jsrc, psrc = jloader.TokenFileSource(token_file), TokenFileSource(token_file)
    jit = jloader.shard_iterator(jloader.LoaderConfig(**kw), source=jsrc, start_step=start)
    pit = shard_iterator(LoaderConfig(**kw), source=psrc, start_step=start)
    for _ in range(6):
        a, b = next(jit), next(pit)
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(jloader.eval_batches(jloader.LoaderConfig(**kw), 2, source=jsrc),
                    eval_batches(LoaderConfig(**kw), 2, source=psrc)):
        np.testing.assert_array_equal(a["labels"], b["labels"])
    np.testing.assert_array_equal(psrc.slice(4_990, 30), jsrc.slice(4_990, 30))


@pytest.mark.parametrize("seq_len,eos", [(8, 0), (16, 999), (5, 3)])
def test_pack_documents_matches_jax(seq_len, eos):
    rng = np.random.default_rng(seq_len)
    docs = [rng.integers(1, 50, size=n).astype(np.int32) for n in (3, 17, 1, 9, 30, 4, 12)]
    docs.append(np.array([eos, 5, eos], np.int32))   # EOS inside a document
    want = jpacking.pack_documents(docs, seq_len, eos)
    got = pack_documents(docs, seq_len, eos)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert not got[2].all()   # some label is masked at a boundary


def test_pack_documents_needs_one_row():
    with pytest.raises(ValueError, match="one packed row"):
        pack_documents([np.arange(3)], 8, 0)
