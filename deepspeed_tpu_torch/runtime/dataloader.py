"""Data loaders.

Port of ``deepspeed_tpu/runtime/dataloader.py`` (``RepeatingLoader`` :15,
``DeepSpeedDataLoader`` :33), the reference's ``runtime/dataloader.py``
(DeepSpeedDataLoader :41, RepeatingLoader :17). The loader yields numpy
batches of the *global* micro-batch; the engine keeps this rank's rows
(``DeepSpeedTpuEngine._shard_batch``), so every rank iterates the same
loader in the same order.
"""

import math
from typing import Any, Callable, Iterator, Optional

import numpy as np


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration (reference dataloader.py:17)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Batches an indexable dataset into global micro-batches.

    `dataset[i]` must return a dict, tuple or list of arrays (or one
    array). Batches are stacked along dim 0 with size micro_batch *
    dp_world (the global micro-batch), dropping the remainder like a
    distributed sampler would; ``shuffle`` permutes with numpy's
    ``default_rng(seed + epoch)``, as the JAX loader does.
    """

    def __init__(self, dataset, micro_batch_size: int, dp_world_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.global_micro = micro_batch_size * dp_world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.len = len(dataset) // self.global_micro if drop_last else \
            math.ceil(len(dataset) / self.global_micro)

    def __len__(self):
        return self.len

    def __iter__(self) -> Iterator[Any]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        self.epoch += 1
        for b in range(self.len):
            sel = idx[b * self.global_micro:(b + 1) * self.global_micro]
            yield self.collate_fn([self.dataset[int(i)] for i in sel])


def _stack(xs):
    return np.stack([np.asarray(x) for x in xs])


def _default_collate(items):
    """Stack a list of samples leaf by leaf (the JAX ``jax.tree.map`` over
    dicts, tuples and lists)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate(list(xs)) for xs in zip(*items))
    return _stack(items)
