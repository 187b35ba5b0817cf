"""Dataset of voxelized SDF grids stored as numbered ``.npy`` files (copy
of ``sdfest_tpu/datasets/sdf_dataset.py``, numpy only): loads
``{folder}/00000.npy, 00001.npy, ...`` and returns ``(1, D, D, D)`` arrays.
"""
from __future__ import annotations

import glob
import os
from typing import Iterator

import numpy as np


class SDFDataset:
    """Map-style dataset over a folder of ``.npy`` SDF volumes."""

    def __init__(self, folder: str):
        self._files = sorted(glob.glob(os.path.join(folder, "*.npy")))
        if not self._files:
            raise FileNotFoundError(f"No .npy SDF files found in {folder}")

    def __len__(self) -> int:
        return len(self._files)

    def __getitem__(self, index: int) -> np.ndarray:
        sdf = np.load(self._files[index]).astype(np.float32)
        return sdf[None]  # (1, D, D, D)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> Iterator[np.ndarray]:
        """Infinite iterator of stacked ``(N, 1, D, D, D)`` batches."""
        rng = np.random.default_rng(seed)
        while True:
            order = np.arange(len(self))
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), batch_size):
                idx = order[start : start + batch_size]
                if len(idx) < batch_size and drop_last:
                    break
                yield np.stack([self[i] for i in idx])
