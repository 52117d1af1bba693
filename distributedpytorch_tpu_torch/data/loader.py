"""Deterministic split and the batch loader.

Counterpart of ``distributedpytorch_tpu/data/loader.py`` without its
native C++ decode path and its fault-injection sites. The indices are the
JAX package's, epoch for epoch:

* ``seeded_split`` — one permutation from ``default_rng(seed)``; the
  first ``int(n * val_fraction)`` indices are the val set;
* ``ShardSpec`` — DistributedSampler's rule: pad by wrapping around to a
  multiple of the world size, then stride by rank;
* ``DataLoader.epoch_batches(epoch)`` — a ``default_rng((seed, epoch))``
  permutation per epoch when shuffling, then consecutive slices, the
  ragged last one dropped under ``drop_last``.

Batches are host numpy arrays, ``{'image': (B, H, W, 3) float32,
'mask': (B, H, W) int32}``; the trainer copies them to the card. Each
batch's assembly is the timeline's ``decode`` span (``utils/trace.py``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from distributedpytorch_tpu_torch.utils.trace import NULL_TIMELINE

Batch = Dict[str, np.ndarray]


def seeded_split(n: int, val_fraction: float, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic ``(train_indices, val_indices)``;
    ``n_val = int(n * val_fraction)`` as the reference rounds it."""
    n_val = int(n * val_fraction)
    perm = np.random.default_rng(seed).permutation(n)
    return perm[n_val:], perm[:n_val]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """The strided shard of each (wrap-padded) epoch that one process
    owns, as ``DistributedSampler(dataset, num_replicas, rank)``."""

    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(
                f"rank {self.rank} out of range for world {self.world}")

    def shard(self, order: np.ndarray) -> np.ndarray:
        if self.world == 1:
            return order
        total = -(-len(order) // self.world) * self.world
        reps = -(-total // len(order))
        padded = np.concatenate([order] * reps)[:total]
        return padded[self.rank :: self.world]


class DataLoader:
    """Batched, optionally sharded iterator over a dataset whose items are
    ``{'image': (H, W, C) float32, 'mask': (H, W) int32}``. With
    ``num_workers > 0`` whole batches decode on a thread pool, two ahead
    of the consumer; ``cache`` (a ``SampleCache``) serves samples decoded
    in an earlier epoch; ``tracer`` (a ``StepTimeline``) times each
    batch's assembly as ``decode``."""

    def __init__(
        self,
        dataset,
        indices: Optional[Sequence[int]] = None,
        batch_size: int = 4,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        shard: ShardSpec = ShardSpec(),
        num_workers: int = 0,
        cache=None,
        tracer=None,
    ):
        self.dataset = dataset
        self.tracer = tracer or NULL_TIMELINE
        self.indices = (np.arange(len(dataset)) if indices is None
                        else np.asarray(indices))
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_spec = shard
        self.num_workers = int(num_workers)
        self.cache = cache

    def __len__(self) -> int:
        """Batches per epoch for this shard."""
        n = self.num_samples()
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def num_samples(self) -> int:
        """Samples per epoch in this process's shard (before drop_last)."""
        return len(self.shard_spec.shard(self.indices))

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = self.indices
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(order)
        return self.shard_spec.shard(order)

    def batch_slices(self, epoch: int = 0) -> list:
        """This epoch's batches as index arrays, in order."""
        order = self._epoch_order(epoch)
        cut = (len(order) - len(order) % self.batch_size if self.drop_last
               else len(order))
        order = order[:cut]
        return [order[s : s + self.batch_size]
                for s in range(0, len(order), self.batch_size)]

    def load_slice(self, idx_list) -> Batch:
        """One batch: cached samples from host memory, the rest decoded."""
        with self.tracer.span("decode", n=len(idx_list)):
            return self._assemble(idx_list)

    def _assemble(self, idx_list) -> Batch:
        items = {}
        for i in map(int, idx_list):
            item = self.cache.get(i) if self.cache is not None else None
            if item is None:
                item = self.dataset[i]
                if self.cache is not None:
                    self.cache.put(i, item)
            items[i] = item
        return {
            "image": np.stack([items[int(i)]["image"] for i in idx_list]),
            "mask": np.stack([items[int(i)]["mask"] for i in idx_list]),
        }

    def epoch_batches(self, epoch: int = 0) -> Iterator[Batch]:
        slices = self.batch_slices(epoch)
        if self.num_workers <= 0:
            for idx in slices:
                yield self.load_slice(idx)
            return
        # two whole-batch decodes in flight; closing the generator early
        # cancels what has not started
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: deque = deque()
            try:
                for idx in slices:
                    pending.append(pool.submit(self.load_slice, idx))
                    if len(pending) > 2:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for fut in pending:
                    fut.cancel()

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch_batches(0)
