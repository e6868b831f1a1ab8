"""MMVit2 and mmformer through the port's two entry points, on the CPU.

* ``run.main`` with ``modeltype`` MMVit2 writes its run directory, and its
  checkpoint loads back as MMVit2 weights (and as nothing else);
* ``run.evaluate --weights`` with a JAX ``.npz`` of mmformer gives the
  probabilities of JAX's ``MMFormer.apply`` on the same images;
* ``run.evaluate.load_weights`` converts an ``.npz`` by the model it is
  loaded into, and raises, naming both, on weights of another model;
* ``pallas_fused_blocks`` and ``decoder_lean`` set for these models print
  one line naming them, and what the port refuses stays refused.
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
from torch_levers import LEVERS, check_entry_points_take
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

MODELS = {"MMVit2": False, "mmformer": True}  # name: the converter's mmformer flag
# ROADMAP Queue 3: the f32 whole-model forward bound (mmformer's forward is
# well conditioned: tests/test_torch_mmvit2.py)
MODEL_ATOL = 5e-5


def _jax_npz(path, name, seed):
    """The ``.npz`` of ``run.evaluate --weights`` made by the JAX converter
    from the port's ``name`` at ``seed``; returns the port's state_dict."""
    sd = create_model(name, seed=seed).state_dict()
    variables = ti.mmvit2_variables_from_state_dict(sd, mmformer=MODELS[name])
    np.savez(path, **flatten_variables(variables))
    return sd


@pytest.mark.parametrize("name", list(MODELS))
def test_load_weights_converts_by_model(name, tmp_path):
    """A JAX ``.npz`` of MMVit2 or mmformer loads as that model, bit for bit;
    loaded as the other model (or as MMVit4) it raises naming both. An
    MMVit4 ``.npz`` loaded as ``name`` raises too."""
    from corrifnet_tpu.models.torch_import import mmvit4_variables_from_state_dict
    from corrifnet_tpu_torch.run.evaluate import load_weights

    want = _jax_npz(tmp_path / "w.npz", name, seed=6)
    got = load_weights(tmp_path / "w.npz", name)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    create_model(name).load_state_dict(got, strict=True)
    torch.save(got, tmp_path / "w.pt")
    assert sorted(load_weights(tmp_path / "w.pt", name)) == sorted(want)
    for other in ("MMVit2", "mmformer", "MMVit4"):
        if other != name:
            for suffix in ("npz", "pt"):
                with pytest.raises(ValueError, match=f"{name} weights, not {other}"):
                    load_weights(tmp_path / f"w.{suffix}", other)
    v4 = mmvit4_variables_from_state_dict(create_model("MMVit4").state_dict(),
                                          pack_stage1=True)
    np.savez(tmp_path / "v4.npz", **flatten_variables(
        {c: v4[c] for c in ("params", "batch_stats")}))
    with pytest.raises(ValueError, match=f"MMVit4 weights, not {name}"):
        load_weights(tmp_path / "v4.npz", name)


def test_training_entry_point_runs_mmvit2(tmp_path, monkeypatch):
    """``run.main`` on the CPU with ``modeltype`` MMVit2 in f32 over 15
    synthetic patches, one epoch of batch 4 (3 steps, the last padded; 1
    validation patch, 3 test patches): the log files, both checkpoints, the
    dated summary and the segplot family are written, the losses sit in the
    double-sigmoid band, and the final checkpoint is MMVit2's state_dict."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import main as run_main
    from corrifnet_tpu_torch.run.evaluate import load_weights
    from corrifnet_tpu_torch.train import Checkpointer

    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "fno": 2, "fsiz": 5, "n_epochs": 1, "modeltype": "MMVit2",
         "synthetic_seed": 0, "dtype": "float32"}))
    r = run_main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])

    run_dir = tmp_path / r["run_dir"]
    for name in ("trainFile", "trainaccFile", "trainepochFile", "valFile", "valaccFile",
                 "testFile", "testaccFile", "fpsfile"):
        assert len((run_dir / f"{name}.txt").read_text().splitlines()) == 1, name
    assert (run_dir / "lrFile.txt").read_text().startswith("Epoch: 0 LR: [0.0001]")
    assert r["train_steps"] == 3
    for loss in (r["history"]["train_loss"][0], r["history"]["val_loss"][0],
                 r["test_loss"]):
        assert 0.5 <= loss <= 1.0
    assert "Model version:MMVit2" in next(run_dir.glob("2*_*.txt")).read_text()
    for name in ("segmentation_image", "test_image", "test_image_R", "test_image_G",
                 "test_image_B", "test_pred_mask", "ground_truth_mask"):
        assert (run_dir / f"{name}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    ckpt = Checkpointer(run_dir)
    assert ckpt.exists("iremmodel0") and ckpt.exists("Finaliremmodel0")
    final = ckpt.restore("Finaliremmodel0")
    assert sorted(final) == sorted(create_model("MMVit2").state_dict())
    assert sorted(load_weights(run_dir / "Finaliremmodel0", "MMVit2")) == sorted(final)
    with pytest.raises(ValueError, match="MMVit2 weights, not mmformer"):
        load_weights(run_dir / "Finaliremmodel0", "mmformer")


def test_evaluate_weights_npz_matches_jax_mmformer(tmp_path, monkeypatch, capsys):
    """``run.evaluate --weights`` with a JAX ``.npz`` of mmformer (and, in
    the config, ``pallas_fused_blocks`` and ``decoder_lean``, which have no
    effect on it): the probabilities of the test fold's two images (one
    batch of 8, padded) equal those of JAX's ``MMFormer.apply`` on the same
    images and weights within MODEL_ATOL, and the no-effect line names both
    fields."""
    from corrifnet_tpu.models.mmvit2 import MMFormer
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import evaluate

    monkeypatch.chdir(tmp_path)
    data.write_permutation(10, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 10, "modeltype": "mmformer", "synthetic_seed": 0,
         "dtype": "float32", "pallas_fused_blocks": True, "decoder_lean": False}))
    sd = _jax_npz(tmp_path / "w.npz", "mmformer", seed=8)
    outputs = []
    build = evaluate.create_model

    def create(*args, **kwargs):
        model = build(*args, **kwargs)
        model.register_forward_hook(lambda m, a, out: outputs.append(out.detach().numpy()))
        return model

    monkeypatch.setattr(evaluate, "create_model", create)
    r = evaluate.main(["--config", "cfg.json", "--weights", "w.npz", "--device", "cpu"])
    assert ("config: pallas_fused_blocks=True, decoder_lean=False have no effect on "
            "mmformer" in capsys.readouterr().out)
    assert r["n_images"] == 2 and r["batch_size"] == 8 and len(outputs) == 1

    tsind, trind, _ = data.cross_val(10, 2, 5)
    images = data.load_dstl(10, trind, synthetic_seed=0).images[tsind]
    variables = ti.mmvit2_variables_from_state_dict(sd, mmformer=True)
    jm = MMFormer(dtype=jnp.float32, use_pallas=False)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False))(
        variables, jnp.asarray(images)))
    got = outputs[0][:len(tsind)]
    assert got.shape == want.shape == (2, 3, 1, 224, 224)
    err = np.abs(got - want).max()
    print("mmformer through run.evaluate against JAX:", err)
    assert err <= MODEL_ATOL, err


@pytest.mark.parametrize("name", list(MODELS))
def test_inert_options_are_named(name, capsys):
    """``pallas_fused_blocks`` or ``decoder_lean`` set for MMVit2 or mmformer
    prints one line naming what is set and builds the model the batch rule
    runs (as the JAX package's ``_build_model``); unset, nothing is printed."""
    create_model(name)
    assert capsys.readouterr().out == ""
    model = create_model(name, pallas_fused_blocks=True)
    assert capsys.readouterr().out == (
        f"config: pallas_fused_blocks=True have no effect on {name} (as in the JAX "
        "package)\n")
    assert model.decoder_fuse.lean is None
    create_model(name, decoder_lean=True)
    assert "decoder_lean=True have no effect" in capsys.readouterr().out


_REFUSED = {"fuse_expand_bn": True, "depth_mode": "pruned", "decoder_chunk": 2,
            "decoder_remat": True, "mesh_shape": [1, 1], "use_pallas": False}


@pytest.mark.parametrize("field", sorted(_REFUSED))
@pytest.mark.parametrize("name", list(MODELS))
def test_entry_points_refuse_for_every_model(name, field, tmp_path, monkeypatch, capsys):
    """MMVit4's four levers are taken by both entry points (``torch_levers``;
    MMVit2 and mmformer take ``depth_mode``, the other three have no effect
    on them). What the port still refuses stays refused with MMVit2 and
    mmformer: both entry points raise naming the field before anything is
    built.
    ``use_pallas=False`` is refused on a CUDA device only, and is asked of
    ``run.evaluate`` alone (``run.main`` names the card before it checks,
    and without a card that raises first)."""
    if field in LEVERS:
        check_entry_points_take(name, field, _REFUSED[field], tmp_path, monkeypatch, capsys)
        return
    from corrifnet_tpu_torch.run import evaluate, main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "modeltype": name,
         field: _REFUSED[field]}))
    on_card = field == "use_pallas"
    for run in (evaluate.main,) if on_card else (main.main, evaluate.main):
        with pytest.raises(NotImplementedError, match=rf"{field}=.*ROADMAP\.md"):
            run(["--config", "cfg.json", "--device", "cuda" if on_card else "cpu"])
