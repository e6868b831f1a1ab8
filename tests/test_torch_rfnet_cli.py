"""RFNet through the port's two entry points, on the CPU.

* ``run.main`` with ``modeltype`` RFNet writes its run directory, its
  checkpoint loads back as RFNet weights (and as no other model's), and the
  default ``transfertype='notr'`` leaves the model as built (it has no 2-D
  conv);
* ``run.evaluate --weights`` with a JAX ``.npz`` of RFNet gives the
  probabilities of JAX's ``RFNet.apply`` on the same images;
* ``run.evaluate.load_weights`` raises, naming both models, on weights of
  another model;
* what the port refuses stays refused.

RFNet's decoder runs at 16^3 to 128^3 whatever the input, and the entry
points at 224x224: these are the heaviest CPU runs of the port's tests
after MMVit4's.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import create_model
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
OTHERS = ("MMVit4", "MMVit2", "RobustMseg")


def test_training_entry_point_runs_rfnet(tmp_path, monkeypatch):
    """``run.main`` on the CPU with ``modeltype`` RFNet in f32 over 15
    synthetic patches, one epoch of batch 2 (6 steps, the last padded; 1
    validation patch, 3 test patches; batch 2 halves the 128^3 volumes'
    autograd memory on the host): the log files, both checkpoints, the
    dated summary and the segplot family are written, the losses sit in the
    double-sigmoid band, and the final checkpoint is RFNet's state_dict; the
    region map generators, which get no gradient, are as built."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import main as run_main
    from corrifnet_tpu_torch.run.evaluate import load_weights
    from corrifnet_tpu_torch.train import Checkpointer

    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "fno": 2, "fsiz": 5, "n_epochs": 1, "modeltype": "RFNet",
         "synthetic_seed": 0, "dtype": "float32", "mini_batch_size": 2}))
    r = run_main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])

    run_dir = tmp_path / r["run_dir"]
    for name in ("trainFile", "trainaccFile", "trainepochFile", "valFile", "valaccFile",
                 "testFile", "testaccFile", "fpsfile"):
        assert len((run_dir / f"{name}.txt").read_text().splitlines()) == 1, name
    assert r["train_steps"] == 6
    for loss in (r["history"]["train_loss"][0], r["history"]["val_loss"][0],
                 r["test_loss"]):
        assert 0.5 <= loss <= 1.0
    summary = next(run_dir.glob("2*_*.txt")).read_text()
    assert "Model version:RFNet" in summary and "Transfer:notr" in summary
    for name in ("segmentation_image", "test_image", "test_pred_mask", "ground_truth_mask"):
        assert (run_dir / f"{name}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    ckpt = Checkpointer(run_dir)
    assert ckpt.exists("iremmodel0") and ckpt.exists("Finaliremmodel0")
    final = ckpt.restore("Finaliremmodel0")
    built = create_model("RFNet").state_dict()
    assert sorted(final) == sorted(built)
    prm = [k for k in built if ".prm_generator" in k]
    assert len(prm) == 40 and all(torch.equal(final[k], built[k]) for k in prm)
    assert not torch.equal(final["decoder_fuse.seg_layer.weight"],
                           built["decoder_fuse.seg_layer.weight"])
    assert sorted(load_weights(run_dir / "Finaliremmodel0", "RFNet")) == sorted(final)
    for other in OTHERS:
        with pytest.raises(ValueError, match=f"RFNet weights, not {other}"):
            load_weights(run_dir / "Finaliremmodel0", other)


def test_evaluate_weights_npz_matches_jax(tmp_path, monkeypatch):
    """``run.evaluate --weights`` with a JAX ``.npz`` of RFNet: the
    probabilities of the test fold's two images (one batch of 8, padded)
    equal those of JAX's ``RFNet.apply`` on the same images and weights
    within MODEL_ATOL; the ``.npz`` loaded as another model raises naming
    both."""
    from corrifnet_tpu.models.rfnet import RFNet
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import evaluate

    monkeypatch.chdir(tmp_path)
    data.write_permutation(10, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 10, "modeltype": "RFNet", "synthetic_seed": 0,
         "dtype": "float32"}))
    variables = ti.rfnet_variables_from_state_dict(create_model("RFNet", seed=8).state_dict())
    np.savez(tmp_path / "w.npz", **flatten_variables(variables))
    outputs = []
    build = evaluate.create_model

    def create(*args, **kwargs):
        model = build(*args, **kwargs)
        model.register_forward_hook(lambda m, a, out: outputs.append(out.detach().numpy()))
        return model

    monkeypatch.setattr(evaluate, "create_model", create)
    r = evaluate.main(["--config", "cfg.json", "--weights", "w.npz", "--device", "cpu"])
    assert r["n_images"] == 2 and r["batch_size"] == 8 and len(outputs) == 1

    tsind, trind, _ = data.cross_val(10, 2, 5)
    images = data.load_dstl(10, trind, synthetic_seed=0).images[tsind]
    fwd = jax.jit(lambda v, xx: RFNet(dtype=jnp.float32).apply(v, xx, False))
    # one image at a time: RFNet's 128^3 volumes make a batch costly on the host
    want = np.concatenate([np.asarray(fwd(variables, jnp.asarray(images[i:i + 1])))
                           for i in range(len(images))])
    got = outputs[0][:len(tsind)]
    assert got.shape == want.shape == (2, 3, 1, 224, 224)
    err = np.abs(got - want).max()
    print("RFNet through run.evaluate against JAX:", err)
    assert err <= MODEL_ATOL, err
    for other in OTHERS:
        with pytest.raises(ValueError, match=f"RFNet weights, not {other}"):
            evaluate.load_weights(tmp_path / "w.npz", other)


_REFUSED = {"fuse_expand_bn": True, "depth_mode": "pruned", "decoder_chunk": 2,
            "decoder_remat": True, "mesh_shape": [1, 1], "use_pallas": False}


@pytest.mark.parametrize("field", sorted(_REFUSED))
def test_entry_points_refuse(field, tmp_path, monkeypatch):
    """What the port refuses stays refused with RFNet: both entry points
    raise naming the field before anything is built (``use_pallas=False``
    on a CUDA device only, asked of ``run.evaluate`` alone, as for the
    other models)."""
    from corrifnet_tpu_torch.run import evaluate, main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "modeltype": "RFNet",
         field: _REFUSED[field]}))
    on_card = field == "use_pallas"
    for run in (evaluate.main,) if on_card else (main.main, evaluate.main):
        with pytest.raises(NotImplementedError, match=rf"{field}=.*ROADMAP\.md"):
            run(["--config", "cfg.json", "--device", "cuda" if on_card else "cpu"])
