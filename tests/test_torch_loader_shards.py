"""The port's PrefetchLoader shards (``num_shards`` / ``shard_index``)
against JAX's equal-shard rule (posfeat_tpu/data/loader.py:57-89): the
same index stream shard by shard over several epochs, disjoint shards of
equal length, and the ValueErrors where the JAX loader spins forever or
says nothing."""

import itertools

import numpy as np
import pytest

from posfeat_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader
from posfeat_tpu_torch.data.loader import PrefetchLoader

EPOCHS = 3


@pytest.mark.parametrize("n, shards", [(7, 2), (7, 3), (8, 2), (8, 3)])
def test_index_stream_matches_jax(n, shards):
    per_epoch = n // shards
    streams = []
    for i in range(shards):
        kw = dict(batch_size=1, shuffle=True, seed=5, infinite=True, num_shards=shards, shard_index=i)
        want = list(itertools.islice(JaxPrefetchLoader(list(range(n)), **kw)._index_stream(), EPOCHS * per_epoch))
        got = list(itertools.islice(PrefetchLoader(list(range(n)), **kw)._index_stream(), EPOCHS * per_epoch))
        assert got == want, (i, got, want)
        streams.append(np.reshape(got, (EPOCHS, per_epoch)))
    for e in range(EPOCHS):  # each epoch: disjoint shards covering n - n % shards indices
        seen = np.concatenate([s[e] for s in streams])
        assert len(set(seen.tolist())) == len(seen) == n - n % shards


def test_one_shard_is_the_unsharded_stream():
    kw = dict(batch_size=1, shuffle=True, seed=2, infinite=True)
    a = list(itertools.islice(PrefetchLoader(list(range(7)), **kw)._index_stream(), 14))
    b = list(itertools.islice(PrefetchLoader(list(range(7)), num_shards=1, shard_index=0, **kw)._index_stream(), 14))
    assert a == b


def test_shards_batch_their_own_samples():
    ds = [{"x": np.array([i], np.float32)} for i in range(9)]
    got = [[int(b["x"][0, 0]) for b in PrefetchLoader(ds, batch_size=1, shuffle=False, num_workers=1,
                                                       num_shards=3, shard_index=i)]
           for i in range(3)]
    assert got == [[0, 3, 6], [1, 4, 7], [2, 5, 8]]


def test_too_small_dataset_and_bad_index_raise():
    # the JAX loader spins forever on a dataset smaller than its shard count
    with pytest.raises(ValueError, match="fewer than its 3 shards"):
        next(iter(PrefetchLoader([{"x": np.zeros(1)}] * 2, batch_size=1, infinite=True, num_shards=3,
                                 shard_index=1)))
    for bad in (-1, 2):
        with pytest.raises(ValueError, match="shard_index"):
            PrefetchLoader([0, 1, 2], batch_size=1, num_shards=2, shard_index=bad)
