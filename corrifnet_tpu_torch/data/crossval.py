"""Deterministic 5-fold cross-validation splitter (reference: F6_CROSSVAL.py).

Counterpart of ``corrifnet_tpu/data/crossval.py``, kept as the port's own
copy (numpy only): the same permutation file gives the same folds in both.

Bit-identical reimplementation of ``CrossVal(N, fno, fsiz)``
(F6_CROSSVAL.py:5-37), validated against the committed split files
(``trind.txt`` 4310 / ``tsind.txt`` 1197 / ``vlind.txt`` 478 lines for
N=5985, fno=1, fsiz=5).

Semantics preserved:
  * ``fno`` is 1-based (``fno = fno - 1`` at F6_CROSSVAL.py:7).
  * The permutation is read from ``randInd{N}.txt`` — here resolved from the
    caller's ``search_dirs``, then the package's ``data/splits`` directory,
    then the CWD (the reference reads from CWD only). ``data/splits`` holds
    ``randInd5985.txt``, the JAX package's committed permutation byte for
    byte, so the default ``train_set_size`` gives the paper's folds from any
    working directory, in both packages.
  * Test fold = positions ``[fno*N/fsiz, (fno+1)*N/fsiz)``.
  * ``trvlind = setdiff1d(ind, tsind)`` — since ``ind`` is a permutation of
    ``range(N)`` this yields the *sorted* complement of the test positions.
  * Validation ratio is hard-coded 0.1 (F6_CROSSVAL.py:27) regardless of the
    config's valRatio line — quirk preserved.
  * Final double indexing ``trind = ind[trind]`` etc. (F6_CROSSVAL.py:33-35).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = ["cross_val", "load_permutation", "write_permutation"]

_SPLITS_DIR = Path(__file__).resolve().parent / "splits"


def load_permutation(n: int, search_dirs=None) -> np.ndarray:
    """Load ``randInd{n}.txt`` (one integer per line) as an int array."""
    name = f"randInd{n}.txt"
    dirs = list(search_dirs or []) + [_SPLITS_DIR, Path(os.getcwd())]
    for d in dirs:
        p = Path(d) / name
        if p.exists():
            return np.loadtxt(p, dtype=np.int64)
    raise FileNotFoundError(
        f"{name} not found in {dirs}; generate one with write_permutation(n)"
    )


def write_permutation(n: int, out_dir=".", seed=None) -> Path:
    """Generate and persist a random permutation file.

    Mirrors RandGenerator.py:1-17 (which shuffles ``range(N)`` and writes one
    index per line), with an optional seed for reproducibility.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    out = Path(out_dir) / f"randInd{n}.txt"
    out.write_text("\n".join(str(int(i)) for i in perm) + "\n")
    return out


def cross_val(n: int, fno: int, fsiz: int, search_dirs=None):
    """Return ``(tsind, trind, vlind)`` exactly as F6_CROSSVAL.py:5-37.

    ``fno`` is 1-based fold number; ``fsiz`` the number of folds.
    """
    ind = load_permutation(n, search_dirs)
    fno = fno - 1
    tstsize = int(n / fsiz)
    if (fno + 1) * tstsize > n:
        # Wrap-around branch. NOTE: the reference's np.concatenate call here
        # (F6_CROSSVAL.py:20) passes ranges positionally and would raise at
        # runtime; we implement the evident intent (wrapped contiguous fold).
        tsind = np.concatenate(
            [
                np.arange((fno * tstsize) % n, n),
                np.arange(0, ((fno + 1) * tstsize) % n),
            ]
        )
    else:
        tsind = np.arange(fno * tstsize, (fno + 1) * tstsize)

    trvlind = np.setdiff1d(ind, tsind)

    val_ratio = 0.1  # hard-coded in the reference (F6_CROSSVAL.py:27)
    valsize = int((n - tstsize) * val_ratio)

    vlind = trvlind[0:valsize]
    trind = trvlind[valsize:]

    trind = ind[trind]
    tsind = ind[tsind]
    vlind = ind[vlind]
    return tsind, trind, vlind
