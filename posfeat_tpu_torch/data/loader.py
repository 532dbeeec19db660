"""Threaded prefetching batch loader (posfeat_tpu/data/loader.py:23-138).

Decoding and the pair geometry run in a thread pool while the card
computes the previous batch. None samples (filtered pairs) are skipped
and replaced, so every batch has the full batch size. Batches are dicts
of numpy arrays; the trainer moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

_STACK_KEYS_EXCLUDE = ("name1", "name2", "pad1", "pad2")


def collate(samples: List[Dict]) -> Dict:
    """Stack numpy sample dicts into a batch dict; names and pads stay
    lists."""
    return {
        key: [s[key] for s in samples] if key in _STACK_KEYS_EXCLUDE
        else np.stack([s[key] for s in samples])
        for key in samples[0]
    }


def batch_rows(batch: Dict, rank: int, world: int) -> Dict:
    """Rank ``rank``'s rows r·b/n .. (r+1)·b/n of a global batch of b
    (arrays and the lists of names and pads alike), as JAX's
    ``shard_batch`` splits one host batch over its devices
    (posfeat_tpu/core/mesh.py:94-113)."""
    out = {}
    for key, v in batch.items():
        b = len(v) // world
        out[key] = v[rank * b:(rank + 1) * b]
    return out


class PrefetchLoader:
    """Iterate dataset indices -> full batches, with worker threads.

    :param dataset: indexable returning dict or None
    :param batch_size: batch size (None samples are replaced)
    :param shuffle: reshuffle indices each epoch
    :param num_workers: prefetch threads
    :param prefetch: max prepared samples in flight
    :param seed: shuffle seed (epoch e shuffles with seed + e)
    :param infinite: loop forever over epochs
    :param num_shards: processes that share the dataset (``multihost:``)
    :param shard_index: this process's shard

    An incomplete last batch of a finite pass is dropped. Shards follow
    JAX's equal-shard rule (posfeat_tpu/data/loader.py:57-89): every
    process shuffles the same permutation (seed + epoch), drops its
    trailing ``n % num_shards`` indices and takes every
    ``num_shards``-th from ``shard_index``, so that shards are disjoint
    and of equal length.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 16,
        seed: int = 0,
        infinite: bool = False,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(prefetch, 2 * batch_size)
        self.seed = seed
        self.infinite = infinite
        self.num_shards = max(1, int(num_shards))
        self.shard_index = int(shard_index)
        if not 0 <= self.shard_index < self.num_shards:
            raise ValueError(f"shard_index {shard_index} is not in [0, {self.num_shards})")

    def _index_stream(self) -> Iterator[int]:
        n = len(self.dataset)
        # the JAX loader spins forever in both cases when infinite
        # (posfeat_tpu/data/loader.py:84)
        if n == 0:
            raise ValueError("the dataset has no sample")
        if n < self.num_shards:
            raise ValueError(f"the dataset has {n} samples, fewer than its {self.num_shards} shards")
        n_even = n - n % self.num_shards
        epoch = 0
        while True:
            idx = np.arange(n)
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(idx)
            yield from idx[:n_even][self.shard_index::self.num_shards].tolist()
            epoch += 1
            if not self.infinite:
                return

    def __iter__(self) -> Iterator[Dict]:
        indices = self._index_stream()
        first = next(indices)  # raises on an empty dataset before a thread starts
        sample_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # gives up once the consumer has stopped, so the thread ends
            while not stop.is_set():
                try:
                    sample_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = [pool.submit(self.dataset.__getitem__, first)]
                    for i in indices:
                        pending.append(pool.submit(self.dataset.__getitem__, i))
                        while len(pending) >= self.num_workers * 2:
                            if not put(("item", pending.pop(0).result())):
                                return
                    for fut in pending:
                        if not put(("item", fut.result())):
                            return
                put(("end", None))
            except Exception as e:  # surfaced on the consumer's thread
                put(("error", e))

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()

        try:
            batch: List[Dict] = []
            while True:
                kind, sample = sample_q.get()
                if kind == "end":
                    break
                if kind == "error":
                    raise sample
                if sample is None:  # filtered pair: skip, keep filling
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
        finally:
            stop.set()
