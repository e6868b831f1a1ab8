"""DSTL multispectral data pipeline (reference: F8_IMAGES4.py).

Counterpart of ``corrifnet_tpu/data/dstl.py``, numpy only: ``DstlArrays``,
``normalize_per_fold``, ``synthetic_dstl``, ``load_pack`` and ``load_dstl``
give the same arrays as the JAX package from the same pack or seed.

The reference loads per-patch ``.mat`` files (RGB patches, 20-channel cubes
sliced into NIR and SWIR, building masks), moves channels to NCHW, subtracts
per-channel means computed on the *training fold only* (F8_IMAGES4.py:60-79),
stacks the three modalities into ``(N, 3, 3, 224, 224)`` and replicates the
masks x3 along the modality axis (F8_IMAGES4.py:87-88). The sources, in the
JAX package's order: an ``.npz`` pack made by :func:`pack_mat_directory`,
the raw ``.mat`` directories (``data_dirs``: ``rgb``, ``all20``, ``mask``;
read with ``scipy.io.loadmat``; masks and cubes paired to the RGB patches by
file name, F8_IMAGES4.py:26), or the synthetic generator.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "DstlArrays",
    "load_dstl",
    "load_pack",
    "normalize_per_fold",
    "pack_mat_directory",
    "synthetic_dstl",
]

LIM = 224  # patch side (F8_IMAGES4.py:39)
NIR_CHANNELS = (9, 10, 11)  # of the 20-channel cube, F8_IMAGES4.py:41-43
SWIR_CHANNELS = (12, 13, 14)  # F8_IMAGES4.py:45-47
_DATA_DIRS = ("rgb", "all20", "mask")  # the config's data_dirs keys


@dataclasses.dataclass
class DstlArrays:
    """Preloaded host-side dataset, reference-shaped.

    images: (N, 3 modalities, 3 channels, H, W) float32, mean-subtracted
    masks:  (N, 3, 1, H, W) float32 in {0, 1}
    tr_mean_r/g/b: training-fold RGB means (F8_IMAGES4.py:95)
    """

    images: np.ndarray
    masks: np.ndarray
    tr_mean_r: float
    tr_mean_g: float
    tr_mean_b: float


def normalize_per_fold(
    rgb: np.ndarray, nir: np.ndarray, swir: np.ndarray, masks: np.ndarray,
    trind: np.ndarray,
) -> DstlArrays:
    """The reference's train-fold mean subtraction and stacking
    (F8_IMAGES4.py:60-88). Inputs are NCHW per modality: (N, 3, H, W);
    masks (N, 1, H, W)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.float32)
    nir = np.ascontiguousarray(nir, dtype=np.float32)
    swir = np.ascontiguousarray(swir, dtype=np.float32)
    masks = np.ascontiguousarray(masks, dtype=np.float32)

    means = []
    for arr in (rgb, nir, swir):
        for c in range(3):
            m = arr[trind, c, :, :].mean()
            arr[:, c, :, :] -= m
            means.append(float(m))

    images = np.stack([rgb, nir, swir], axis=1)  # (N, 3, 3, H, W)
    masks5 = np.repeat(masks[:, None], 3, axis=1)  # (N, 3, 1, H, W)
    return DstlArrays(images, masks5, means[0], means[1], means[2])


def synthetic_dstl(
    n: int,
    trind: Optional[np.ndarray] = None,
    lim: int = LIM,
    seed: int = 0,
) -> DstlArrays:
    """Synthetic data with DSTL shapes and dtypes. Masks are unions of random
    rectangles, some patches are all background (the Jaccard2 inversion,
    F5_JACCARD2.py:12-14), and the images correlate with the masks."""
    rng = np.random.default_rng(seed)
    if trind is None:
        trind = np.arange(n)

    masks = np.zeros((n, 1, lim, lim), dtype=np.float32)
    for i in range(n):
        for _ in range(int(rng.integers(0, 4))):  # 0 rects => all-background
            h = int(rng.integers(lim // 8, lim // 2))
            w = int(rng.integers(lim // 8, lim // 2))
            y0 = int(rng.integers(0, lim - h))
            x0 = int(rng.integers(0, lim - w))
            masks[i, 0, y0 : y0 + h, x0 : x0 + w] = 1.0

    def modality(scale):
        base = rng.normal(0.0, 1.0, size=(n, 3, lim, lim)).astype(np.float32)
        return base + scale * masks  # signal correlated with the mask

    rgb, nir, swir = modality(2.0), modality(1.5), modality(1.0)
    return normalize_per_fold(rgb, nir, swir, masks, trind)


def _load_one_mat(path, key: str = "inputPatch") -> np.ndarray:
    """One array of a ``.mat`` file."""
    import scipy.io as sio

    return sio.loadmat(path, verify_compressed_data_integrity=False)[key]


def _load_mat_dir(directory, limit: int, key: str = "inputPatch", names=None):
    """(names, float32 array) of up to ``limit`` ``.mat`` files of
    ``directory``, in sorted order; with ``names``, exactly those files, a
    missing one raising ``FileNotFoundError`` that names it (the reference
    pairs the masks to the RGB patches by file name,
    ``class06_mats/{rgb_name}``, F8_IMAGES4.py:26)."""
    if names is None:
        names = sorted(os.listdir(directory))[:limit]
    arrays = []
    for name in names:
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"counterpart file {name!r} missing from {directory}: the RGB, "
                "cube and mask directories must share file names")
        arrays.append(_load_one_mat(path, key))
    return names, np.asarray(arrays, dtype=np.float32)


def _read_mat_dirs(rgb_dir, all20_dir, mask_dir, limit):
    """(names, rgb, nir, swir, masks) of the first ``limit`` patches, NCHW."""
    names, rgb = _load_mat_dir(rgb_dir, limit)
    _, cube = _load_mat_dir(all20_dir, limit, names=names)
    _, mask = _load_mat_dir(mask_dir, limit, names=names)
    return (names, np.moveaxis(rgb, 3, 1), np.moveaxis(cube[..., list(NIR_CHANNELS)], 3, 1),
            np.moveaxis(cube[..., list(SWIR_CHANNELS)], 3, 1),
            mask.reshape(len(names), 1, LIM, LIM))


def pack_mat_directory(rgb_dir, all20_dir, mask_dir, out_path, limit: int) -> Path:
    """Convert the reference's ``.mat`` layout once into one compressed
    ``.npz`` (``rgb``, ``nir``, ``swir``, ``masks``, ``names``) that
    :func:`load_pack` reads."""
    names, rgb, nir, swir, masks = _read_mat_dirs(rgb_dir, all20_dir, mask_dir, limit)
    out = Path(out_path)
    np.savez_compressed(out, rgb=rgb, nir=nir, swir=swir, masks=masks,
                        names=np.asarray(names))
    return out


def load_pack(pack_path, trind: np.ndarray, limit: Optional[int] = None) -> DstlArrays:
    """Load an ``.npz`` pack (``rgb``, ``nir``, ``swir``, ``masks``) and normalize."""
    with np.load(pack_path, allow_pickle=False) as z:
        sl = slice(None, limit)
        return normalize_per_fold(z["rgb"][sl], z["nir"][sl], z["swir"][sl],
                                  z["masks"][sl], trind)


def load_dstl(
    train_set_size: int,
    trind: np.ndarray,
    pack_path: Optional[str] = None,
    synthetic_seed: Optional[int] = None,
    data_dirs: Optional[dict] = None,
) -> DstlArrays:
    """``get_images4`` equivalent (F8_IMAGES4.py:11-95): an explicit pack
    file, else the ``.mat`` directories of ``data_dirs`` (``rgb``,
    ``all20``, ``mask``), else synthetic data when ``synthetic_seed`` is
    given. A ``data_dirs`` that names no directory under one of its keys, or
    whose RGB directory holds fewer than ``train_set_size`` files, raises
    (the JAX package falls through to the synthetic data on a missing RGB
    directory)."""
    if pack_path and Path(pack_path).exists():
        return load_pack(pack_path, trind, limit=train_set_size)
    if data_dirs:
        dirs = [data_dirs.get(k) for k in _DATA_DIRS]
        absent = [k for k, d in zip(_DATA_DIRS, dirs) if not (d and os.path.isdir(d))]
        if absent:
            raise FileNotFoundError(f"data_dirs {absent} name no directory: {data_dirs}")
        names, rgb, nir, swir, masks = _read_mat_dirs(*dirs, train_set_size)
        if len(names) < train_set_size:
            raise FileNotFoundError(f"{dirs[0]} holds {len(names)} files, fewer than "
                                    f"train_set_size {train_set_size}")
        return normalize_per_fold(rgb, nir, swir, masks, trind)
    if synthetic_seed is not None:
        return synthetic_dstl(train_set_size, trind, seed=synthetic_seed)
    raise FileNotFoundError(
        "No DSTL source found: pass data_pack, data_dirs or synthetic_seed for "
        "generated data."
    )
