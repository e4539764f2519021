"""The port's synthetic data pipeline against the JAX package's: the token
streams must be bit for bit the same for the same seed, shard and shard
count (both are numpy; no tolerance)."""
import itertools

import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro_torch.data.pipeline import DataConfig, SyntheticLM


def _both(**kw):
    return SyntheticLM(DataConfig(**kw)), JaxSyntheticLM(JaxDataConfig(**kw))


@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 1), (0, 2), (7, 4)])
def test_batches_bit_identical_over_seeds_and_shards(seed, shards):
    port, ref = _both(vocab_size=1000, seq_len=64, global_batch=8, seed=seed,
                      mean_doc_len=48)
    for shard in range(shards):
        a = list(itertools.islice(port.batches(shard, shards), 5))
        b = list(itertools.islice(ref.batches(shard, shards), 5))
        for x, y in zip(a, b):
            assert set(x) == set(y) == {"tokens", "labels"}
            for k in x:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                np.testing.assert_array_equal(x[k], y[k])
            assert x["tokens"].shape == (8 // shards, 64)


def test_packed_rows_bit_identical_at_the_model_vocab():
    port, ref = _both(vocab_size=50304, seq_len=2048, global_batch=4, seed=0)
    for x, y in zip(itertools.islice(port.packed_rows(0, 1), 2),
                    itertools.islice(ref.packed_rows(0, 1), 2)):
        np.testing.assert_array_equal(x, y)


def test_data_deterministic_and_packed():
    """The port of ``test_substrates.test_data_deterministic_and_packed``:
    labels are the next token, EOS between documents."""
    dc = DataConfig(vocab_size=1000, seq_len=64, global_batch=4, seed=3,
                    mean_doc_len=16)
    a = next(SyntheticLM(dc).batches())
    b = next(SyntheticLM(dc).batches())
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    rows = next(SyntheticLM(dc).packed_rows(0, 1))
    np.testing.assert_array_equal(rows[:, :-1], a["tokens"])
    np.testing.assert_array_equal(rows[:, 1:], a["labels"])
    assert (rows == dc.eos_id).any() and rows.min() >= 1
    assert rows.max() < dc.vocab_size


def test_shards_are_disjoint_streams():
    dc = DataConfig(vocab_size=1000, seq_len=32, global_batch=8, seed=0)
    s0 = next(SyntheticLM(dc).batches(shard=0, n_shards=2))
    s1 = next(SyntheticLM(dc).batches(shard=1, n_shards=2))
    assert s0["tokens"].shape == (4, 32)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
