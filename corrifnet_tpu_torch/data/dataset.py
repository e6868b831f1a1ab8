"""Batch iteration over preloaded arrays (reference: F3_DATASET.py + DataLoader).

Counterpart of ``corrifnet_tpu/data/dataset.py`` (``Batch``,
``batch_iterator``, ``make_batches``, ``num_batches``), numpy only. The
reference iterates preloaded tensors with ``DataLoader(batch_size,
shuffle=False)`` (F2_MAIN.py:90, 104-111): all randomization lives in the
permutation file, so the order is fixed by construction.

Batches are padded to a static batch size and carry a per-sample validity
mask, as in the JAX package; the train and eval steps weight losses and
metrics by that mask, which reproduces the reference's ``batchLoad``-weighted
accumulation (F4_TRAIN.py:65-71) including the final partial batch, and
keeps one tensor shape per run.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["Batch", "batch_iterator", "make_batches", "num_batches"]


@dataclasses.dataclass
class Batch:
    images: np.ndarray  # (B, 3, 3, H, W) float32 (padded)
    masks: np.ndarray   # (B, 3, 1, H, W) float32 (padded)
    valid: np.ndarray   # (B,) float32: 1.0 for real samples, 0.0 for padding


def num_batches(n: int, batch_size: int) -> int:
    return -(-n // batch_size)


def batch_iterator(
    images: np.ndarray,
    masks: np.ndarray,
    indices: np.ndarray,
    batch_size: int,
) -> Iterator[Batch]:
    """Yield fixed-shape padded batches over ``images[indices]`` in order."""
    n = len(indices)
    for start in range(0, n, batch_size):
        idx = indices[start : start + batch_size]
        b = len(idx)
        im = images[idx]
        ma = masks[idx]
        valid = np.ones((batch_size,), dtype=np.float32)
        if b < batch_size:
            pad = batch_size - b
            im = np.concatenate([im, np.zeros((pad, *im.shape[1:]), im.dtype)])
            ma = np.concatenate([ma, np.zeros((pad, *ma.shape[1:]), ma.dtype)])
            valid[b:] = 0.0
        yield Batch(im, ma, valid)


def make_batches(
    images: np.ndarray,
    masks: np.ndarray,
    indices: np.ndarray,
    batch_size: int,
) -> Iterator[Batch]:
    """Batch source of the training and evaluation loops: the vectorized
    numpy gather. (The JAX package's optional C++ batcher is not ported.)"""
    return batch_iterator(images, masks, indices, batch_size)
