"""The port's device-resident data and wire cast against the JAX package.

``wire_cast_batch``, ``DeviceDataset`` (resident on the CPU here: the same
gather, the same bits), ``fits_bytes`` and the choice of
``_maybe_device_dataset`` against their JAX counterparts
(``corrifnet_tpu/data/dataset.py``, ``corrifnet_tpu/run/main.py``); then the
port against itself, as ``tests/test_train_loop.py`` holds the JAX package:
a bf16 run trains to the same bits with the wire cast on and off, and a run
with the data resident equals a streamed one.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import corrifnet_tpu_torch.data.crossval as port_cv
from corrifnet_tpu.data import dataset as jax_dataset
from corrifnet_tpu_torch.config import ExperimentConfig
from corrifnet_tpu_torch.data import (
    Batch,
    DeviceDataset,
    batch_iterator,
    synthetic_dstl,
    wire_cast_batch,
    write_permutation,
)
from corrifnet_tpu_torch.run import main as run_main
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_tiny_model import TinySeg5D, registered  # noqa: F401


def _bits(t):
    """A bf16 tensor or array as its uint16 bit patterns."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _arrays(masks_kind, n=7, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 3, 3, 8, 8)).astype(np.float32)
    # ties and neighbours of the bf16 grid: round to nearest even
    images[0, 0, 0, 0, :6] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40, -0.0,
                              3.4e38]
    masks = (rng.random((n, 3, 1, 8, 8)) > 0.5).astype(np.float32)
    if masks_kind == "soft":
        masks[1, 0, 0, 0, 0] = 0.5
    return images, masks


@pytest.mark.parametrize("masks_kind", ["binary", "soft"])
def test_wire_cast_batch_matches_jax(masks_kind):
    """The same bf16 bits (rounded to nearest even) and the same masks:
    uint8 where exact, else f32 untouched."""
    images, masks = _arrays(masks_kind)
    valid = np.array([1, 1, 0], np.float32)
    want = jax_dataset.wire_cast_batch(jax_dataset.Batch(images[:3], masks[:3], valid))
    got = wire_cast_batch(Batch(images[:3], masks[:3], valid))
    assert got.images.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got.images), _bits(want.images))
    assert got.masks.numpy().dtype == want.masks.dtype
    assert got.masks.dtype == (torch.uint8 if masks_kind == "binary" else torch.float32)
    np.testing.assert_array_equal(got.masks.numpy(), want.masks)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("subset", [None, [5, 2, 6]])
def test_device_dataset_batches_match_host_batcher_and_jax(wire, subset):
    """Resident batches, the padded tail's rows zeroed, equal the port's
    host batcher (wire-cast where the set is) and JAX's ``DeviceDataset``
    bit for bit, for the whole set and a resident subset."""
    images, masks = _arrays("binary")
    indices = np.array([3, 0, 6, 2, 5]) if subset is None else np.array(subset)
    dd = DeviceDataset(images, masks, wire_cast=wire, indices=subset, device="cpu")
    jd = jax_dataset.DeviceDataset(images, masks, wire_cast=wire, indices=subset)
    assert dd.covers(indices) and dd.nbytes == jd.nbytes
    assert dd.covers([1]) == jd.covers([1]) == (subset is None)
    got = list(dd.batches(indices, 2))
    host = list(batch_iterator(images, masks, indices, 2))
    jax_batches = list(jd.batches(indices, 2))
    assert len(got) == len(host) == len(jax_batches) == (3 if subset is None else 2)
    for g, h, j in zip(got, host, jax_batches):
        h = wire_cast_batch(h) if wire else Batch(*map(torch.from_numpy, (
            h.images, h.masks, h.valid)))
        assert g.images.dtype == h.images.dtype and g.masks.dtype == h.masks.dtype
        assert torch.equal(g.images, h.images) and torch.equal(g.masks, h.masks)
        assert torch.equal(g.valid, h.valid)
        ji = np.asarray(j.images)
        np.testing.assert_array_equal(_bits(g.images) if wire else g.images.numpy(),
                                      _bits(ji) if wire else ji)
        np.testing.assert_array_equal(g.masks.numpy(), np.asarray(j.masks))
        np.testing.assert_array_equal(g.valid.numpy(), j.valid)


def test_fits_bytes_matches_jax(monkeypatch):
    for budget_gb in ("0.5", "5", None):
        if budget_gb is None:
            monkeypatch.delenv("CORRIFNET_DEVICE_DATA_BUDGET_GB", raising=False)
        else:
            monkeypatch.setenv("CORRIFNET_DEVICE_DATA_BUDGET_GB", budget_gb)
        for images in (1e8, 3e9, 9.6e9, 1.2e10):
            for wire in (False, True):
                for mc in (False, True):
                    for budget in (None, 2e9):
                        args = (int(images), int(images / 3), wire, budget)
                        assert (DeviceDataset.fits_bytes(*args, mask_compressible=mc)
                                == jax_dataset.DeviceDataset.fits_bytes(
                                    *args, mask_compressible=mc)), (budget_gb, args, mc)
    _, masks = _arrays("binary")
    assert DeviceDataset._masks_compressible(masks)
    assert not DeviceDataset._masks_compressible(_arrays("soft")[1])


class _JaxBf16:
    """What JAX's ``_wire_cast_enabled`` reads of a bf16 model."""

    dtype = jax.numpy.bfloat16


@pytest.mark.parametrize("mode", ["auto", "0", "1"])
def test_resident_choice_matches_jax(monkeypatch, mode):
    """Over a grid of budgets the port chooses on a CUDA device what JAX
    chooses on an accelerator: the whole set, the validation and test
    folds, the validation fold or nothing (as in
    ``tests/test_train_loop.py``'s ``test_maybe_device_dataset_val_fold_auto``);
    ``CORRIFNET_DEVICE_DATA`` 0 and 1 as in JAX; on the CPU the auto
    choice is none, as JAX's on its CPU backend."""
    from corrifnet_tpu.run.main import _maybe_device_dataset as jax_choose

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if mode == "auto":
        monkeypatch.delenv("CORRIFNET_DEVICE_DATA", raising=False)
    else:
        monkeypatch.setenv("CORRIFNET_DEVICE_DATA", mode)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(10, 3, 3, 16, 16)).astype(np.float32)
    masks = (rng.random((10, 3, 1, 16, 16)) > 0.5).astype(np.float32)
    vlind, tsind = np.array([1, 4]), np.array([7, 8, 9])
    port_model = TinySeg5D(dtype=torch.bfloat16)
    per_sample = images[0].nbytes // 2 + masks[0].nbytes // 4  # wire-cast
    for samples in (0.5, 1, 2, 3, 5, 6, 9, 10, 1000):
        monkeypatch.setenv("CORRIFNET_DEVICE_DATA_BUDGET_GB", str(samples * per_sample / 1e9))
        jd = jax_choose(_JaxBf16(), images, masks, None, vlind, tsind)
        got = run_main._resident_choice(port_model, images, masks, vlind, tsind, "cuda")
        assert (got is None) == (jd is None), samples
        if got is not None:
            rows = np.arange(10) if got[0] is None else got[0]
            for probe in (vlind, tsind, [0], np.arange(10)):
                held = set(np.asarray(probe).tolist()) <= set(np.asarray(rows).tolist())
                assert jd.covers(probe) == held, (samples, probe)
        cpu = run_main._resident_choice(port_model, images, masks, vlind, tsind, "cpu")
        assert (cpu is not None) == (mode == "1")


def _train(data, trind, vlind, wire, monkeypatch, device_data=None):
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.train import init_state, train_model

    monkeypatch.setenv("CORRIFNET_WIRE_CAST", wire)
    model = create_model("TinySegBf16", dtype=torch.bfloat16, seed=0)
    state, history = train_model(
        init_state(model, "Adam"), n_epochs=2, learn_rate=1e-3, step_size=5, gamma=0.9,
        images=data.images, masks=data.masks, trind=trind, vlind=vlind, batch_size=3,
        lim=16, logs=None, ckpt=None, i=0, seed=1, val_from_checkpoint=False,
        device_data=device_data)
    del history["step_seconds"]
    return model.state_dict(), history


def test_wire_cast_training_is_bit_identical(registered, monkeypatch):
    """A bf16 model trains to the same bits with the wire cast on and off:
    the same rounding happens before the copy instead of in the model's
    first op. An f32 model never receives bf16 images."""
    from corrifnet_tpu_torch.train.loop import _wire_cast_enabled

    data = synthetic_dstl(12, lim=16, seed=0)
    trind, vlind = np.arange(8), np.arange(8, 10)
    on = _train(data, trind, vlind, "1", monkeypatch)
    off = _train(data, trind, vlind, "0", monkeypatch)
    assert on[1] == off[1]
    assert all(torch.equal(on[0][k], off[0][k]) for k in on[0])
    monkeypatch.setenv("CORRIFNET_WIRE_CAST", "1")
    assert _wire_cast_enabled(TinySeg5D(dtype=torch.bfloat16))
    assert not _wire_cast_enabled(TinySeg5D(dtype=torch.float32))


@pytest.mark.parametrize("resident", ["dataset", "val+test-fold"])
def test_resident_run_equals_streamed(tmp_path, registered, monkeypatch, resident):
    """The whole entry point with the data resident (the whole set, or the
    validation and test folds with the training batches streamed) equals
    the streamed run: history, test metrics and final weights, bit for bit."""
    write_permutation(24, tmp_path, seed=0)
    monkeypatch.setattr(port_cv, "_SPLITS_DIR", tmp_path)
    cfg = ExperimentConfig(train_set_size=24, fno=1, fsiz=4, mini_batch_size=4,
                           n_epochs=2, learn_rate=1e-3, modeltype="TinySegBf16",
                           lim=224, synthetic_seed=0)
    tsind, _, vlind = port_cv.cross_val(24, 1, 4)

    def run(root):
        return run_main.run_experiment(cfg, run_root=tmp_path / root, device="cpu")

    with monkeypatch.context() as m:
        if resident == "dataset":
            m.setenv("CORRIFNET_DEVICE_DATA", "1")
        else:
            m.setattr(run_main, "_resident_choice", lambda *a: (
                np.concatenate([vlind, tsind]), resident))
        res_d = run("dev")
    monkeypatch.setenv("CORRIFNET_DEVICE_DATA", "0")
    res_s = run("stream")
    n = 24 if resident == "dataset" else len(vlind) + len(tsind)
    assert res_d["resident_bytes"] == n * (3 * 3 * 224 * 224 * 2 + 3 * 224 * 224)
    assert res_s["resident_bytes"] == 0
    assert res_d["test_jaccard"] == res_s["test_jaccard"]
    assert res_d["test_loss"] == res_s["test_loss"]
    for k in ("train_loss", "train_jac", "val_loss", "val_jac"):
        assert res_d["history"][k] == res_s["history"][k], k
    fd = torch.load(f"{res_d['run_dir']}/Finaliremmodel0", weights_only=True)
    fs = torch.load(f"{res_s['run_dir']}/Finaliremmodel0", weights_only=True)
    assert all(torch.equal(fd[k], fs[k]) for k in fd)
