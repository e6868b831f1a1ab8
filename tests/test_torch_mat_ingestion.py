"""The port's raw ``.mat`` ingestion against the JAX package, on the CPU.

Synthetic patches in the reference's directory layout (RGBs / all20Ch /
class06_mats, F8_IMAGES4.py:20-32; the cube compressed), written as
``tests/test_dstl_ingestion.py`` writes them, go through the port's
``load_dstl(data_dirs=...)`` and ``pack_mat_directory`` and through the JAX
package's: the arrays, names and training means must be equal bit for bit.
A missing counterpart file raises naming it, and ``run.main`` trains the
5-D stand-in (``tests/torch_tiny_model.py``) for one epoch from the
directories.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import scipy.io as sio

from corrifnet_tpu.data import load_dstl as jax_load_dstl
from corrifnet_tpu.data import load_pack as jax_load_pack
from corrifnet_tpu.data import pack_mat_directory as jax_pack
from corrifnet_tpu_torch.data import load_dstl, load_pack, pack_mat_directory, write_permutation
from corrifnet_tpu_torch.data.dstl import LIM
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_tiny_model import registered  # noqa: F401

N = 15  # 3 steps of 4, 1 validation and 3 test patches at fold 2 of 5
PARITY_N = 6


@pytest.fixture(scope="module")
def mat_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dstl")
    dirs = {key: root / name for key, name in
            (("rgb", "RGBs"), ("all20", "all20Ch"), ("mask", "class06_mats"))}
    for d in dirs.values():
        d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(N):
        name = f"patch{i:03d}.mat"
        sio.savemat(dirs["rgb"] / name, {"inputPatch": rng.normal(100, 20, (LIM, LIM, 3))})
        sio.savemat(dirs["all20"] / name, {"inputPatch": rng.normal(50, 10, (LIM, LIM, 20))},
                    do_compression=True)
        sio.savemat(dirs["mask"] / name,
                    {"inputPatch": (rng.random((LIM, LIM)) > 0.8).astype(np.float64)})
    return root, {k: str(v) for k, v in dirs.items()}


def _assert_same(got, want):
    for field in ("images", "masks"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for field in ("tr_mean_r", "tr_mean_g", "tr_mean_b"):
        assert getattr(got, field) == getattr(want, field), field


def test_load_dstl_from_mat_dirs_equals_jax(mat_dirs):
    _, dirs = mat_dirs
    trind = np.array([0, 2, 3, 5])
    got = load_dstl(PARITY_N, trind, data_dirs=dirs)
    want = jax_load_dstl(PARITY_N, trind, rgb_dir=dirs["rgb"], all20_dir=dirs["all20"],
                         mask_dir=dirs["mask"])
    assert got.images.shape == (PARITY_N, 3, 3, LIM, LIM)
    assert got.masks.shape == (PARITY_N, 3, 1, LIM, LIM)
    _assert_same(got, want)
    # NIR is channels 9-11 of the cube, SWIR 12-14 (F8_IMAGES4.py:41-47)
    cube = sio.loadmat(f"{dirs['all20']}/patch001.mat")["inputPatch"].astype(np.float32)
    for m, first in ((1, 9), (2, 12)):
        shift = got.images[1, m] - np.moveaxis(cube[..., first:first + 3], 2, 0)
        assert np.ptp(shift, axis=(1, 2)).max() < 1e-3  # the training mean alone


def test_pack_mat_directory_equals_jax(mat_dirs):
    root, dirs = mat_dirs
    ours = pack_mat_directory(dirs["rgb"], dirs["all20"], dirs["mask"], root / "port.npz",
                              PARITY_N)
    theirs = jax_pack(dirs["rgb"], dirs["all20"], dirs["mask"], str(root / "jax.npz"), PARITY_N)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == ["masks", "names", "nir", "rgb", "swir"]
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    trind = np.arange(4)
    _assert_same(load_pack(ours, trind), jax_load_pack(str(theirs), trind))
    # the pack loads to what the directories load to
    _assert_same(load_dstl(PARITY_N, trind, pack_path=str(ours)),
                 load_dstl(PARITY_N, trind, data_dirs=dirs))


def test_missing_counterpart_raises_naming_it(mat_dirs, tmp_path):
    _, dirs = mat_dirs
    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    for i in (0, 1, 2, 4, 5):
        shutil.copy(f"{dirs['mask']}/patch{i:03d}.mat", mask_dir)
    with pytest.raises(FileNotFoundError, match="'patch003.mat' missing from"):
        load_dstl(PARITY_N, np.arange(4), data_dirs={**dirs, "mask": str(mask_dir)})
    with pytest.raises(FileNotFoundError, match="'patch003.mat' missing from"):
        pack_mat_directory(dirs["rgb"], dirs["all20"], str(mask_dir), tmp_path / "p.npz",
                           PARITY_N)
    with pytest.raises(FileNotFoundError, match="name no directory"):
        load_dstl(PARITY_N, np.arange(4), data_dirs={**dirs, "all20": str(tmp_path / "none")},
                  synthetic_seed=0)
    with pytest.raises(FileNotFoundError, match="fewer than train_set_size"):
        load_dstl(N + 1, np.arange(4), data_dirs=dirs)


def test_training_entry_point_reads_mat_dirs(mat_dirs, tmp_path, monkeypatch, registered):  # noqa: F811
    """``run.main`` trains ``TinySeg5D`` for one epoch from ``data_dirs``,
    on the arrays ``load_dstl`` reads from them."""
    from corrifnet_tpu_torch.data import cross_val
    from corrifnet_tpu_torch.run import main as run_main

    _, dirs = mat_dirs
    monkeypatch.chdir(tmp_path)
    write_permutation(N, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": N, "fno": 2, "fsiz": 5, "n_epochs": 1, "modeltype": "TinySeg5D",
         "data_dirs": dirs, "dtype": "float32"}))
    seen = []
    build = run_main.create_model

    def create(*args, **kwargs):
        model = build(*args, **kwargs)
        model.register_forward_hook(lambda m, a, out: seen.append(a[0].detach().clone()))
        return model

    monkeypatch.setattr(run_main, "create_model", create)
    r = run_main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])
    assert r["train_steps"] == 3
    _, trind, _ = cross_val(N, 2, 5)
    arrays = load_dstl(N, trind, data_dirs=dirs)
    np.testing.assert_array_equal(seen[0][:4].numpy(), arrays.images[trind[:4]])
    run_dir = tmp_path / r["run_dir"]
    assert (run_dir / "Finaliremmodel0").is_file()
    assert len((run_dir / "testaccFile.txt").read_text().splitlines()) == 1
