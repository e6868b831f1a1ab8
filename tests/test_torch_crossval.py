"""The permutation that fixes the paper's folds ships with the port.

``corrifnet_tpu_torch/data/splits/randInd5985.txt`` is the JAX package's
committed ``randInd5985.txt``, byte for byte: at the default
``train_set_size`` of 5985 both packages split from it, whatever the
working directory holds. Every test here runs from an empty ``tmp_path``
working directory and leaves the packages' search paths as they are.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from corrifnet_tpu.data import crossval as jax_crossval
from corrifnet_tpu_torch.data import crossval as port_crossval
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

N = 5985
_JAX_SPLITS = Path(jax_crossval.__file__).resolve().parent / "splits"
_PORT_SPLITS = Path(port_crossval.__file__).resolve().parent / "splits"


def test_the_port_ships_the_committed_permutation():
    name = f"randInd{N}.txt"
    assert (_PORT_SPLITS / name).read_bytes() == (_JAX_SPLITS / name).read_bytes()


@pytest.mark.parametrize("fno", [1, 2, 3, 4, 5])
def test_default_folds_equal_the_jax_package(tmp_path, monkeypatch, fno):
    monkeypatch.chdir(tmp_path)
    assert not (tmp_path / f"randInd{N}.txt").exists()
    want = jax_crossval.cross_val(N, fno, 5)
    got = port_crossval.cross_val(N, fno, 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert [len(g) for g in got] == [1197, 4310, 478]


def test_the_default_fold_is_the_committed_split(tmp_path, monkeypatch):
    """The committed ``trind``/``tsind``/``vlind.txt`` are fold 2 (1-based,
    the config's default ``fno``; 1 when counted from 0, as the reference's
    ``CrossVal`` counts after ``fno = fno - 1``)."""
    monkeypatch.chdir(tmp_path)
    tsind, trind, vlind = port_crossval.cross_val(N, 2, 5)
    for name, got in (("trind", trind), ("tsind", tsind), ("vlind", vlind)):
        want = np.loadtxt(_JAX_SPLITS / f"{name}.txt", dtype=np.int64)
        np.testing.assert_array_equal(got, want)


def test_a_decoy_in_the_working_directory_changes_no_fold(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want_jax = jax_crossval.cross_val(N, 2, 5)
    want_port = port_crossval.cross_val(N, 2, 5)
    decoy = port_crossval.write_permutation(N, tmp_path, seed=123)
    assert decoy.parent == tmp_path
    assert not np.array_equal(np.loadtxt(decoy, dtype=np.int64),
                              np.loadtxt(_PORT_SPLITS / decoy.name, dtype=np.int64))
    for want, cross_val in ((want_jax, jax_crossval.cross_val),
                            (want_port, port_crossval.cross_val)):
        for w, g in zip(want, cross_val(N, 2, 5)):
            np.testing.assert_array_equal(g, w)
