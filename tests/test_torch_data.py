"""The port's own config and data modules against the JAX package's.

``corrifnet_tpu_torch.config`` and ``corrifnet_tpu_torch.data`` are copies
(numpy only) of modules of the JAX package that the port may not import.
The same files and seeds must give the same values in both: every
comparison here is exact.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from corrifnet_tpu import config as jax_config
from corrifnet_tpu import data as jax_data
from corrifnet_tpu.data import dataset as jax_dataset
from corrifnet_tpu_torch import config as port_config
from corrifnet_tpu_torch import data as port_data

_TEXT_LINES = ["40", "2", "5", "0.1", "4", "3", "0.0002", "SGD",
               "BCEWithLogitsLoss", "BCEWithLogitsLoss", "Jaccard",
               "kaiming_normal_", "7", "0.8", "224", "MMVit4", "1", "notr"]


def test_config_fields_and_defaults_equal_the_jax_config():
    want = {f.name: f.default for f in dataclasses.fields(jax_config.ExperimentConfig)}
    got = {f.name: f.default for f in dataclasses.fields(port_config.ExperimentConfig)}
    assert got == want
    assert not hasattr(port_config.ExperimentConfig, "jax_dtype")


def test_text_config_loads_the_same(tmp_path):
    path = tmp_path / "model0.txt"
    path.write_text("\n".join(_TEXT_LINES) + "\n")
    want = dataclasses.asdict(jax_config.load_config(path))
    got = dataclasses.asdict(port_config.load_config(path))
    assert got == want and got["optimizer_type"] == "SGD" and got["gamma"] == 0.8


def test_json_config_loads_the_same(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"train_set_size": 40, "dtype": "float32",
                                "data_dirs": {"rgb": "a"}, "synthetic_seed": 3}))
    want = dataclasses.asdict(jax_config.load_config(path))
    assert dataclasses.asdict(port_config.load_config(path)) == want


def test_short_text_config_raises(tmp_path):
    path = tmp_path / "short.txt"
    path.write_text("\n".join(_TEXT_LINES[:10]))
    with pytest.raises(ValueError, match="expected 18 config lines"):
        port_config.load_config(path)


@pytest.mark.parametrize("n,fno", [(40, 2), (15, 1), (103, 5)])
def test_cross_val_equals_the_jax_package(tmp_path, n, fno):
    port_data.write_permutation(n, tmp_path, seed=n)
    perm_port = (tmp_path / f"randInd{n}.txt").read_text()
    jax_data.write_permutation(n, tmp_path, seed=n)
    assert (tmp_path / f"randInd{n}.txt").read_text() == perm_port
    np.testing.assert_array_equal(port_data.load_permutation(n, [tmp_path]),
                                  jax_data.load_permutation(n, [tmp_path]))
    want = jax_data.cross_val(n, fno, 5, [tmp_path])
    got = port_data.cross_val(n, fno, 5, [tmp_path])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ts, tr, vl = got
    assert len(set(ts) | set(tr) | set(vl)) == n == len(ts) + len(tr) + len(vl)


def test_synthetic_dstl_equals_the_jax_package():
    trind = np.array([0, 2, 3, 5])
    want = jax_data.synthetic_dstl(6, trind, lim=32, seed=4)
    got = port_data.synthetic_dstl(6, trind, lim=32, seed=4)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.masks, want.masks)
    assert (got.tr_mean_r, got.tr_mean_g, got.tr_mean_b) == (
        want.tr_mean_r, want.tr_mean_g, want.tr_mean_b)
    assert got.images.shape == (6, 3, 3, 32, 32) and got.masks.shape == (6, 3, 1, 32, 32)


def test_load_pack_and_load_dstl_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(5)
    arrays = {name: rng.normal(0, 1, (5, 3, 8, 8)).astype(np.float32)
              for name in ("rgb", "nir", "swir")}
    arrays["masks"] = (rng.random((5, 1, 8, 8)) > 0.5).astype(np.float32)
    pack = tmp_path / "pack.npz"
    np.savez(pack, **arrays)
    trind = np.array([0, 1, 3])
    want = jax_data.load_dstl(4, trind, pack_path=str(pack))
    got = port_data.load_dstl(4, trind, pack_path=str(pack))
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.masks, want.masks)
    assert got.images.shape[0] == 4
    via_pack = port_data.load_pack(pack, trind, limit=4)
    np.testing.assert_array_equal(via_pack.images, got.images)


def test_load_dstl_sources(tmp_path):
    trind = np.arange(3)
    with pytest.raises(NotImplementedError, match="data_dirs"):
        port_data.load_dstl(3, trind, data_dirs={"rgb": str(tmp_path)})
    with pytest.raises(FileNotFoundError):
        port_data.load_dstl(3, trind)


@pytest.mark.parametrize("batch_size", [2, 4])
def test_batches_equal_the_jax_package(batch_size):
    rng = np.random.default_rng(6)
    images = rng.normal(0, 1, (7, 3, 3, 4, 4)).astype(np.float32)
    masks = (rng.random((7, 3, 1, 4, 4)) > 0.5).astype(np.float32)
    idx = np.array([6, 1, 4, 0, 2])
    want = list(jax_dataset.make_batches(images, masks, idx, batch_size, use_native=False))
    got = list(port_data.make_batches(images, masks, idx, batch_size))
    assert len(got) == len(want) == port_data.num_batches(5, batch_size) \
        == jax_data.num_batches(5, batch_size)
    for a, b in zip(got, want):
        assert isinstance(a, port_data.Batch)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.masks, b.masks)
        np.testing.assert_array_equal(a.valid, b.valid)
    assert got[-1].valid.sum() == 5 - batch_size * (len(got) - 1)
