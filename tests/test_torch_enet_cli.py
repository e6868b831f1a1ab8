"""ENet through the port's two entry points, on the CPU.

* ``run.main`` with ``modeltype`` ENet and the default ``chindex`` (0)
  trains on RGB and channel 0 of the masks at 224x224, with BatchNorm on
  batch statistics and every bottleneck's Dropout2d, writes its run
  directory with no segplot, and ``notr`` re-initializes the 89 kernels
  that the JAX package does, the two transposed convs among them;
  ``run.evaluate`` of the final weights gives JAX's probabilities, within
  the larger of 5e-5 and twice the port's own change under a 1e-6 change
  of the input (``tests/torch_zoo_cli.py``): its trained weights amplify
  f32 rounding;
* ``load_weights`` reads a JAX ``.npz`` and a reference ``.pt``: the
  reference's ``state_dict`` holds each encoder bottleneck's one PReLU
  slope under several keys, as the port's does, and its dead
  ``project_layer``, which is dropped; it names the model on a mismatch.
"""

from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import create_model
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_cli import train_then_evaluate, weights_files

OTHERS = ("MMVit4", "ELANet", "FASSDNet", "UNetV2")


def test_training_entry_point_runs_enet(tmp_path, monkeypatch):
    """``run.main`` then ``run.evaluate`` on the CPU, f32, 15 synthetic
    patches, one epoch of batch 4, ``chindex`` 0; the shared slopes of the
    final checkpoint are one value under each of their keys; the weights
    are named as ENet's by ``load_weights``."""
    from corrifnet_tpu.models.enet import ENet
    from corrifnet_tpu_torch.run.evaluate import load_weights

    final = train_then_evaluate(tmp_path, monkeypatch, "ENet", "0",
                                lambda: ENet(dtype=jnp.float32),
                                ti.enet_variables_from_state_dict, 89, witness=True)
    slope = final["regular1_1.out_prelu.weight"]
    assert slope.ne(0.25).all()
    for place in ("ext_conv1.2", "ext_conv2.2", "ext_conv3.2"):
        assert torch.equal(final[f"regular1_1.{place}.weight"], slope)
    path = next(tmp_path.glob("*/Finaliremmodel0"))
    for other in OTHERS:
        with pytest.raises(ValueError, match=f"ENet weights, not {other}"):
            load_weights(path, other)


def test_load_weights_reads_jax_npz_and_reference_pt(tmp_path):
    """A JAX ``.npz`` and a reference ``.pt`` of the same weights (the
    ``.pt`` with ``num_batches_tracked`` beside every BatchNorm, the
    duplicate PReLU keys and a ``project_layer`` conv) load into the port as
    its own ``state_dict``, bit for bit; either one named as another model
    raises naming both."""
    from corrifnet_tpu_torch.run.evaluate import load_weights

    model, npz, pt = weights_files(tmp_path, "ENet", ti.enet_variables_from_state_dict)
    sd = torch.load(pt)
    sd["project_layer.weight"] = torch.ones(1, 128, 1, 1)
    torch.save(sd, pt)
    assert sd["asymmetric2_3.ext_conv2.5.weight"].shape == (1,)
    for path in (npz, pt):
        loaded = load_weights(path, "ENet")
        create_model("ENet").load_state_dict(loaded, strict=True)
        assert sorted(loaded) == sorted(model.state_dict())
        assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
        with pytest.raises(ValueError, match="ENet weights, not ELANet"):
            load_weights(path, "ELANet")
