"""ELANet through the port's two entry points, on the CPU.

* ``run.main`` with ``modeltype`` ELANet and ``chindex`` 1 trains on the
  modality the JAX package's ``_prepare_images`` picks (NIR) and on
  channel 0 of the masks, at 224x224, with BatchNorm on batch statistics
  and the decoder's dropout at 0.5, writes its run directory with no
  segplot, and ``notr`` re-initializes the 100 conv kernels that the JAX
  package does; ``run.evaluate`` of the final weights takes modality 0 and
  gives JAX's probabilities (``tests/torch_zoo_cli.py``);
* ``load_weights`` reads a JAX ``.npz`` and a reference ``.pt``, and names
  the model on a mismatch.
"""

from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import create_model
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_cli import train_then_evaluate, weights_files

OTHERS = ("MMVit4", "FASSDNet", "ENet", "DeepLabv3_plus")


def test_training_entry_point_runs_elanet_on_nir(tmp_path, monkeypatch):
    """``run.main`` then ``run.evaluate`` on the CPU, f32, 15 synthetic
    patches, one epoch of batch 4, ``chindex`` 1; the BatchNorm running
    statistics moved in training; the final checkpoint's weights are named
    as ELANet's by ``load_weights``."""
    from corrifnet_tpu.models.elanet import ELANet
    from corrifnet_tpu_torch.run.evaluate import load_weights

    final = train_then_evaluate(tmp_path, monkeypatch, "ELANet", "1",
                                lambda: ELANet(dtype=jnp.float32),
                                ti.elanet_variables_from_state_dict, 100)
    assert final["decode.bnpre.bn.running_var"].ne(1).all()
    path = next(tmp_path.glob("*/Finaliremmodel0"))
    for other in OTHERS:
        with pytest.raises(ValueError, match=f"ELANet weights, not {other}"):
            load_weights(path, other)


def test_load_weights_reads_jax_npz_and_reference_pt(tmp_path):
    """A JAX ``.npz`` and a reference ``.pt`` of the same weights (the
    ``.pt`` with ``num_batches_tracked`` beside every BatchNorm) load into
    the port as its own ``state_dict``, bit for bit; either one named as
    another model raises naming both."""
    from corrifnet_tpu_torch.run.evaluate import load_weights

    model, npz, pt = weights_files(tmp_path, "ELANet", ti.elanet_variables_from_state_dict)
    assert "decode.SA.conv.1.conv.weight" in torch.load(pt)
    for path in (npz, pt):
        loaded = load_weights(path, "ELANet")
        create_model("ELANet").load_state_dict(loaded, strict=True)
        assert sorted(loaded) == sorted(model.state_dict())
        assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
        with pytest.raises(ValueError, match="ELANet weights, not FASSDNet"):
            load_weights(path, "FASSDNet")
