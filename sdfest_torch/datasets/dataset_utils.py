"""Batching utilities: collation, simple loaders, multi-dataset mixing
(copy of ``sdfest_tpu/datasets/dataset_utils.py``, numpy only).

Host-side numpy; batches are handed to the training step as arrays.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def load_image(path: str, dtype=None) -> np.ndarray:
    """An image file as a numpy array.  PIL is imported here, so the
    modules that read images import where PIL is absent."""
    from PIL import Image

    return np.asarray(Image.open(path), dtype=dtype)


def collate_samples(
    samples: Sequence[Dict[str, np.ndarray]],
    max_points: int = 2500,
    rng: Optional[np.random.Generator] = None,
    fixed_points: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Collate sample dicts into a batch dict.

    Point sets (key ``"pointset"``) of varying sizes are randomly
    subsampled to the smallest set size in the batch, capped at
    ``max_points``.  With ``fixed_points`` set, every point set is
    resampled (with replacement when short) to exactly that size instead,
    so every batch has one shape.  Non-array entries (paths, strings) are
    dropped; other entries are stacked.

    Args:
        samples: Sequence of sample dicts with matching keys.
        max_points: Maximum number of points per set (variable-size mode).
        rng: PRNG used for subsampling.
        fixed_points: Exact output point count (static-shape mode).
    Returns:
        Dict of batched arrays with leading batch dimension.
    """
    if rng is None:
        rng = np.random.default_rng()
    batch: Dict[str, np.ndarray] = {}
    keys = samples[0].keys()
    for key in keys:
        values = [np.asarray(s[key]) for s in samples]
        if values[0].dtype.kind in "US":  # strings (paths) don't batch
            continue
        if key == "pointset":
            if fixed_points is not None:
                resampled = []
                for v in values:
                    idx = rng.choice(
                        v.shape[0],
                        size=fixed_points,
                        replace=v.shape[0] < fixed_points,
                    )
                    resampled.append(v[idx])
                batch[key] = np.stack(resampled)
            else:
                target = min(min(v.shape[0] for v in values), max_points)
                subsampled = []
                for v in values:
                    if v.shape[0] > target:
                        idx = rng.choice(v.shape[0], size=target, replace=False)
                        subsampled.append(v[idx])
                    else:
                        subsampled.append(v)
                batch[key] = np.stack(subsampled)
        else:
            batch[key] = np.stack(values)
    return batch


def make_fixed_size_collate(fixed_points: int):
    """Collate function with a fixed per-set point count."""

    def collate(samples, max_points=2500, rng=None):
        return collate_samples(
            samples, max_points=max_points, rng=rng, fixed_points=fixed_points
        )

    return collate


class ShuffledLoader:
    """Infinite shuffling batch loader over a map-style dataset.

    A torch-free ``DataLoader`` substitute: yields collated batches of
    ``batch_size`` samples, reshuffling each epoch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        collate=collate_samples,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self._dataset = dataset
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._collate = collate
        self._rng = np.random.default_rng(seed)
        self._drop_last = drop_last

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            order = np.arange(len(self._dataset))
            if self._shuffle:
                self._rng.shuffle(order)
            for start in range(0, len(order), self._batch_size):
                idx = order[start : start + self._batch_size]
                if len(idx) < self._batch_size and self._drop_last:
                    break
                samples = [self._dataset[i] for i in idx]
                yield self._collate(samples, rng=self._rng)

    def num_batches_per_epoch(self) -> int:
        return len(self._dataset) // self._batch_size


class MultiDataLoader:
    """Infinite iterator sampling among data loaders with probabilities.

    Mirrors the reference MultiDataLoader (dataset_utils.py:61-88): each
    ``next`` draws one loader according to ``probabilities`` and yields its
    next batch; exhausted iterators restart.
    """

    def __init__(
        self,
        data_loaders: List,
        probabilities: List[float],
        seed: int = 0,
    ):
        if len(data_loaders) != len(probabilities):
            raise ValueError("One probability per data loader required.")
        total = sum(probabilities)
        self._data_loaders = data_loaders
        self._probabilities = [p / total for p in probabilities]
        self._iterators = [iter(dl) for dl in data_loaders]
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        index = self._rng.choice(len(self._iterators), p=self._probabilities)
        try:
            return next(self._iterators[index])
        except StopIteration:
            self._iterators[index] = iter(self._data_loaders[index])
            return next(self._iterators[index])
