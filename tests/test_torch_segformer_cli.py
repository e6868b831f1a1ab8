"""Segformer through the port's two entry points, on the CPU.

* ``run.main`` with ``modeltype`` Segformer and ``chindex`` 2 trains on the
  modality the JAX package's ``_prepare_images`` picks (SWIR) and on
  channel 0 of the masks, at 224x224 (the default ``out_size``), writes its
  run directory with no segplot, and ``notr`` re-initializes the 66 conv
  kernels that the JAX package does; ``run.evaluate`` of the final weights
  takes modality 0, as the JAX package's ``evaluate_run`` does, and gives
  JAX's probabilities (``tests/torch_zoo_cli.py``);
* ``load_weights`` reads a JAX ``.npz`` and a reference ``.pt`` (the patch
  embeds as ``(O, I*k*k, 1, 1)`` 1x1 weights, as the port keeps them), and
  names the model on a mismatch.
"""

from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import create_model
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_cli import train_then_evaluate, weights_files

OTHERS = ("MMVit4", "UNetV2", "DeepLabv3_plus")


def test_training_entry_point_runs_segformer_on_swir(tmp_path, monkeypatch):
    """``run.main`` then ``run.evaluate`` on the CPU, f32, 15 synthetic
    patches, one epoch of batch 4, ``chindex`` 2; the final checkpoint's
    weights are named as Segformer's by ``load_weights``."""
    from corrifnet_tpu.models.segformer import Segformer
    from corrifnet_tpu_torch.run.evaluate import load_weights

    train_then_evaluate(tmp_path, monkeypatch, "Segformer", "2",
                        lambda: Segformer(dtype=jnp.float32),
                        ti.segformer_variables_from_state_dict, 66)
    final = next(tmp_path.glob("*/Finaliremmodel0"))
    for other in OTHERS:
        with pytest.raises(ValueError, match=f"Segformer weights, not {other}"):
            load_weights(final, other)


def test_load_weights_reads_jax_npz_and_reference_pt(tmp_path):
    """A JAX ``.npz`` and a reference ``.pt`` of the same weights load into
    the port as its own ``state_dict``, bit for bit; either one named as
    another model raises naming both."""
    from corrifnet_tpu_torch.run.evaluate import load_weights

    model, npz, pt = weights_files(tmp_path, "Segformer", ti.segformer_variables_from_state_dict)
    assert model.state_dict()["mit.stages.1.1.weight"].shape == (64, 32 * 9, 1, 1)
    for path in (npz, pt):
        loaded = load_weights(path, "Segformer")
        create_model("Segformer").load_state_dict(loaded, strict=True)
        assert sorted(loaded) == sorted(model.state_dict())
        assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
        with pytest.raises(ValueError, match="Segformer weights, not DeepLabv3_plus"):
            load_weights(path, "DeepLabv3_plus")
