"""RobustMseg through the port's two entry points, on the CPU.

* ``run.main`` with ``modeltype`` RobustMseg writes its run directory, with
  the default ``transfertype='notr'`` re-initializing the 54 kernels that
  the JAX package does (and the final checkpoint loads back as RobustMseg
  weights, and as no other model's);
* ``run.evaluate --weights`` with a JAX ``.npz`` of RobustMseg gives the
  probabilities of JAX's ``RobustMseg.apply`` on the same images;
* ``run.evaluate.load_weights`` raises, naming both models, on weights of
  another model;
* what the port refuses stays refused.
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
OTHERS = ("MMVit4", "mmformer", "RFNet")


def test_training_entry_point_runs_robustseg(tmp_path, monkeypatch):
    """``run.main`` on the CPU with ``modeltype`` RobustMseg in f32 over 15
    synthetic patches, one epoch of batch 4 (3 steps, the last padded; 1
    validation patch, 3 test patches), ``initialization`` xavier_normal_
    under the default ``transfertype='notr'``: the log files, both
    checkpoints, the dated summary and the segplot family are written, the
    losses sit in the double-sigmoid band; the style encoders and the
    reconstruction decoders, which get no gradient, are as built, the 54
    re-initialized kernels are not."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
    from corrifnet_tpu_torch.run import main as run_main
    from corrifnet_tpu_torch.run.evaluate import load_weights
    from corrifnet_tpu_torch.train import Checkpointer

    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "fno": 2, "fsiz": 5, "n_epochs": 1,
         "modeltype": "RobustMseg", "synthetic_seed": 0, "dtype": "float32",
         "initialization": "xavier_normal_"}))
    r = run_main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])

    run_dir = tmp_path / r["run_dir"]
    for name in ("trainFile", "trainaccFile", "trainepochFile", "valFile", "valaccFile",
                 "testFile", "testaccFile", "fpsfile"):
        assert len((run_dir / f"{name}.txt").read_text().splitlines()) == 1, name
    assert r["train_steps"] == 3
    for loss in (r["history"]["train_loss"][0], r["history"]["val_loss"][0],
                 r["test_loss"]):
        assert 0.5 <= loss <= 1.0
    summary = next(run_dir.glob("2*_*.txt")).read_text()
    assert "Model version:RobustMseg" in summary and "Transfer:notr" in summary
    for name in ("segmentation_image", "test_image", "test_pred_mask", "ground_truth_mask"):
        assert (run_dir / f"{name}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    ckpt = Checkpointer(run_dir)
    assert ckpt.exists("iremmodel0") and ckpt.exists("Finaliremmodel0")
    final = ckpt.restore("Finaliremmodel0")
    built = create_model("RobustMseg").state_dict()
    assert sorted(final) == sorted(built)
    reinit = apply_reference_init_scheme(create_model("RobustMseg"), "xavier_normal_",
                                         run_main.scheme_generator(0))
    assert len(reinit) == 54
    for key, value in built.items():
        if key.startswith(("style_enc_list.", "recon_decoders.")):
            assert torch.equal(final[key], value) == (key not in reinit), key
    assert sorted(load_weights(run_dir / "Finaliremmodel0", "RobustMseg")) == sorted(final)
    for other in OTHERS:
        with pytest.raises(ValueError, match=f"RobustMseg weights, not {other}"):
            load_weights(run_dir / "Finaliremmodel0", other)


def test_evaluate_weights_npz_matches_jax(tmp_path, monkeypatch):
    """``run.evaluate --weights`` with a JAX ``.npz`` of RobustMseg: the
    probabilities of the test fold's two images (one batch of 8, padded)
    equal those of JAX's ``RobustMseg.apply`` on the same images and weights
    within MODEL_ATOL; the ``.npz`` loaded as another model raises naming
    both."""
    from corrifnet_tpu.models.robustseg import RobustMseg
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import evaluate

    monkeypatch.chdir(tmp_path)
    data.write_permutation(10, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 10, "modeltype": "RobustMseg", "synthetic_seed": 0,
         "dtype": "float32"}))
    variables = ti.robustseg_variables_from_state_dict(
        create_model("RobustMseg", seed=8).state_dict())
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
    jm = RobustMseg(dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False))(
        variables, jnp.asarray(images)))
    got = outputs[0][:len(tsind)]
    assert got.shape == want.shape == (2, 3, 1, 224, 224)
    err = np.abs(got - want).max()
    print("RobustMseg through run.evaluate against JAX:", err)
    assert err <= MODEL_ATOL, err
    for other in OTHERS:
        with pytest.raises(ValueError, match=f"RobustMseg weights, not {other}"):
            evaluate.load_weights(tmp_path / "w.npz", other)


_REFUSED = {"fuse_expand_bn": True, "depth_mode": "pruned", "decoder_chunk": 2,
            "decoder_remat": True, "mesh_shape": [1, 1], "use_pallas": False}


@pytest.mark.parametrize("field", sorted(_REFUSED))
def test_entry_points_refuse(field, tmp_path, monkeypatch):
    """What the port refuses stays refused with RobustMseg: both entry points
    raise naming the field before anything is built (``use_pallas=False``
    on a CUDA device only, asked of ``run.evaluate`` alone, as for the
    other models)."""
    from corrifnet_tpu_torch.run import evaluate, main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "modeltype": "RobustMseg",
         field: _REFUSED[field]}))
    on_card = field == "use_pallas"
    for run in (evaluate.main,) if on_card else (main.main, evaluate.main):
        with pytest.raises(NotImplementedError, match=rf"{field}=.*ROADMAP\.md"):
            run(["--config", "cfg.json", "--device", "cuda" if on_card else "cpu"])
