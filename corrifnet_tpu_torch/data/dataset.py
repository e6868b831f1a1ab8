"""Batch iteration over preloaded arrays (reference: F3_DATASET.py + DataLoader).

Counterpart of ``corrifnet_tpu/data/dataset.py`` (``Batch``,
``batch_iterator``, ``make_batches``, ``num_batches``, ``wire_cast_batch``,
``DeviceDataset``). The host batcher is numpy only; the wire cast and the
device-resident set hand out torch tensors. The
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
import os
from typing import Iterator

import numpy as np
import torch

__all__ = ["Batch", "DeviceDataset", "batch_iterator", "make_batches",
           "num_batches", "wire_cast_batch"]


@dataclasses.dataclass
class Batch:
    """numpy arrays from the host batcher; torch tensors from
    ``wire_cast_batch`` (on the CPU) and ``DeviceDataset`` (on its device)."""

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


def _masks_to_uint8(masks: np.ndarray) -> np.ndarray:
    """f32 masks as uint8 where that is exact, else the masks unchanged."""
    if masks.dtype == np.float32:
        m8 = masks.astype(np.uint8)
        if (m8 == masks).all():
            return m8
    return masks


def wire_cast_batch(b: Batch) -> Batch:
    """A host batch as CPU tensors with fewer bytes to copy to the device,
    computing the same:

    * images f32 -> bf16, rounded to nearest even (torch's cast). Exact
      only where the model computes in bf16 (every ported model casts its
      input first, ``models/mmvit4.py``, ``models/mmvit2.py``): the same
      cast happens before the copy instead of after. Callers gate on the
      compute dtype (``train.loop._wire_cast_enabled``).
    * masks f32 -> uint8 where every value is exactly representable (the
      binary building masks); the train and eval steps cast them back to
      f32. Other masks stay f32.
    * valid: unchanged.
    """
    im = torch.from_numpy(b.images)
    if im.dtype == torch.float32:
        im = im.to(torch.bfloat16)
    return Batch(im, torch.from_numpy(_masks_to_uint8(b.masks)),
                 torch.from_numpy(b.valid))


class DeviceDataset:
    """The data set resident on the device: copied there once, every batch
    gathered there with ``index_select``.

    The reference copies each batch from host memory every epoch
    (F2_MAIN.py:104-111), though the batch sequence is the same every
    epoch (all randomness lives in the permutation file), so the set can
    stay on the card; in bf16 and uint8 the reference's 5,985 patches take
    6.3 GB (over the default budget of ``fits_bytes``, so by default its
    validation and test folds are resident).

    A resident batch equals the host batcher's bit for bit: padded rows are
    zeroed with ``torch.where`` on the validity mask, as the host batcher
    pads with zeros, and the wire casts are the casts a bf16 model makes on
    the device (``wire_cast_batch``). ``batches`` stands wherever
    ``make_batches`` and a copy to the device would stream.
    """

    def __init__(self, images: np.ndarray, masks: np.ndarray,
                 wire_cast: bool = False, indices=None, device="cuda"):
        """``indices``: keep only these samples resident (e.g. the
        validation fold, evaluated every epoch, F4_TRAIN.py:96-180);
        ``batches`` then accepts only indices inside the subset (see
        ``covers``) and maps them to resident rows on the host."""
        self._local = None
        if indices is not None:
            indices = np.asarray(indices)
            images, masks = images[indices], masks[indices]
            self._local = {int(g): i for i, g in enumerate(indices)}
        if wire_cast:
            b = wire_cast_batch(Batch(images, masks, np.ones((1,), np.float32)))
            im, ma = b.images, b.masks
        else:
            im, ma = torch.from_numpy(images), torch.from_numpy(masks)
        self.device = torch.device(device)
        self.images = im.to(self.device)
        self.masks = ma.to(self.device)
        self.nbytes = (self.images.numel() * self.images.element_size()
                       + self.masks.numel() * self.masks.element_size())

    @staticmethod
    def _masks_compressible(masks: np.ndarray) -> bool:
        """Whether ``wire_cast_batch`` turns these masks into uint8, tested
        in chunks so that no uint8 copy of the whole set is made."""
        if masks.dtype != np.float32:
            return False
        flat = masks.reshape(-1)
        step = 1 << 24
        for i in range(0, flat.size, step):
            c = flat[i:i + step]
            if not (c.astype(np.uint8) == c).all():
                return False
        return True

    @staticmethod
    def fits(images: np.ndarray, masks: np.ndarray, wire_cast: bool,
             budget_bytes: float = None) -> bool:
        """Whether the set, as it would be resident, fits the budget that
        ``fits_bytes`` sets, leaving the rest of the card to the model."""
        return DeviceDataset.fits_bytes(
            images.nbytes, masks.nbytes, wire_cast, budget_bytes,
            mask_compressible=(
                wire_cast and DeviceDataset._masks_compressible(masks)),
        )

    @staticmethod
    def fits_bytes(image_bytes: int, mask_bytes: int, wire_cast: bool,
                   budget_bytes: float = None,
                   mask_compressible: bool = False) -> bool:
        """Whether ``image_bytes`` and ``mask_bytes`` of f32, resident,
        stay within ``budget_bytes`` (default
        ``CORRIFNET_DEVICE_DATA_BUDGET_GB``, 5 GB: the JAX package's
        default, so one environment places the same data in both). The
        masks count as uint8 only when ``mask_compressible`` says the wire
        cast really makes them so."""
        if budget_bytes is None:
            budget_bytes = 1e9 * float(
                os.environ.get("CORRIFNET_DEVICE_DATA_BUDGET_GB", "5"))
        n = image_bytes + mask_bytes
        if wire_cast:
            n = image_bytes // 2 + (
                mask_bytes // 4 if mask_compressible else mask_bytes)
        return n <= budget_bytes

    def covers(self, indices) -> bool:
        """Whether every (global) index is resident; always for the whole set."""
        if self._local is None:
            return True
        return all(int(i) in self._local for i in np.asarray(indices))

    def batches(self, indices, batch_size: int) -> Iterator[Batch]:
        """Fixed-shape padded batches over ``indices`` in order, the
        ``batch_iterator`` contract, gathered on the device. The rows and
        validity of all the batches go to the device once per call."""
        indices = np.asarray(indices, dtype=np.int64)
        if self._local is not None:
            indices = np.asarray([self._local[int(i)] for i in indices], np.int64)
        n = len(indices)
        shape = (num_batches(n, batch_size), batch_size)
        rows = np.zeros(shape, np.int64)
        rows.flat[:n] = indices
        valid = np.zeros(shape, np.float32)
        valid.flat[:n] = 1.0
        rows = torch.from_numpy(rows).to(self.device)
        valid = torch.from_numpy(valid).to(self.device)
        for idx, v in zip(rows, valid):
            yield Batch(self._gather(self.images, idx, v),
                        self._gather(self.masks, idx, v), v)

    @staticmethod
    def _gather(data, idx, valid):
        keep = (valid > 0).view((-1,) + (1,) * (data.dim() - 1))
        return torch.where(keep, data.index_select(0, idx), 0)
