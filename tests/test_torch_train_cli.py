"""The port's training entry point on the CPU, and the model it builds.

* ``test_training_cli_on_cpu``: ``run.main`` end to end, MMVit4 in f32
  (moved here from ``tests/test_torch_train.py``, unchanged, so that a test
  run's workers take it apart from that file's whole-step tests);
* ``run.main`` builds every registry model with MMVit4's four levers as
  the JAX package's ``_build_model`` builds it
  (``corrifnet_tpu/run/main.py:48-67``): each lever reaches MMVit4, only
  ``depth_mode`` reaches MMVit2 and mmformer, and no other model takes any.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from corrifnet_tpu_torch.models.registry import available_models, get_spec
from torch_levers import LEVERS, Built
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)


def test_training_cli_on_cpu(tmp_path, monkeypatch):
    """The training entry point end to end on the CPU: MMVit4 in f32 over 15
    synthetic patches, 1 epoch of batch 4 (3 steps with a padded tail, 1
    validation patch, 3 test patches). The log files and both checkpoints
    are written, the losses sit in the double-sigmoid band, and validation
    by restoring the checkpoint equals validation on the live model."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.run import main as run_main
    from corrifnet_tpu_torch.train import Checkpointer, loop

    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    # remat_mode changes no bit (tests/test_torch_remat.py); "none" spares
    # the CPU the default's recompute of the encoders' tail blocks
    cfg = {"train_set_size": 15, "fno": 2, "fsiz": 5, "n_epochs": 1,
           "modeltype": "MMVit4", "synthetic_seed": 0, "dtype": "float32",
           "remat_mode": "none"}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError, match="extended_checkpoints"):
        run_main.main(["--config", "cfg.json", "--device", "cpu", "--resume", "some_dir"])
    r = run_main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])

    run_dir = tmp_path / r["run_dir"]
    lines = {}
    for name in ("trainFile", "trainaccFile", "trainepochFile", "valFile",
                 "valaccFile", "testFile", "testaccFile", "fpsfile", "lrFile"):
        lines[name] = (run_dir / f"{name}.txt").read_text().splitlines()
    assert all(len(lines[n]) == 1 for n in lines if n != "lrFile")
    assert lines["trainepochFile"] == ["0"]
    assert lines["lrFile"][0] == "Epoch: 0 LR: [0.0001]"
    assert len(lines["lrFile"]) == 6
    assert float(lines["trainFile"][0]) == r["history"]["train_loss"][0]
    assert float(lines["testaccFile"][0]) == r["test_jaccard"]
    assert r["train_steps"] == 3 and len(r["history"]["step_seconds"]) == 2
    for loss in (r["history"]["train_loss"][0], r["history"]["val_loss"][0],
                 r["test_loss"]):
        assert 0.5 <= loss <= 1.0
    assert len(list(run_dir.glob("2*_*.txt"))) == 1  # the dated summary
    assert "Model version:MMVit4" in next(run_dir.glob("2*_*.txt")).read_text()
    # the first test image's segplot family, and the curves (matplotlib is
    # installed here)
    for name in ("segmentation_image", "test_image", "test_image_R", "test_image_G",
                 "test_image_B", "test_pred_mask", "ground_truth_mask",
                 "learning_curves", "accuracy_curves"):
        assert (run_dir / f"{name}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name

    ckpt = Checkpointer(run_dir)
    assert ckpt.exists("iremmodel0") and ckpt.exists("Finaliremmodel0")
    assert not list(run_dir.glob("*.tmp"))
    final = ckpt.restore("Finaliremmodel0")
    epoch = ckpt.restore("iremmodel0")
    assert sorted(final) == sorted(create_model("MMVit4").state_dict())
    assert all(torch.equal(final[k], epoch[k]) for k in final)  # one epoch

    # validation by restore == validation on the live model
    model = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=1)
    model.load_state_dict(final)
    tsind, trind, vlind = data.cross_val(15, 2, 5)
    arrays = data.load_dstl(15, trind, synthetic_seed=0)
    live = loop.validate(model, arrays.images, arrays.masks, vlind, 4, 224, None,
                         None, 0, val_from_checkpoint=False)
    restored = loop.validate(create_model("MMVit4", seed=2), arrays.images,
                             arrays.masks, vlind, 4, 224, None, ckpt, 0,
                             val_from_checkpoint=True)
    assert live == restored
    np.testing.assert_allclose(live[0], r["history"]["val_loss"][0], rtol=1e-6)
    np.testing.assert_allclose(live[1], r["history"]["val_jac"][0], rtol=1e-6)


@pytest.mark.parametrize("field", sorted(LEVERS))
@pytest.mark.parametrize("name", available_models())
def test_run_main_builds_the_levers_as_jax(name, field, tmp_path, monkeypatch):
    """``run.main`` with one lever off its default: the keyword it gives
    ``create_model``, applied to the port's model (built on the meta
    device), sets what the JAX package's ``_build_model`` sets on its
    module for the same config, and a model the JAX entry point does not
    give the lever to does not take it (``create_model`` names it as having
    no effect)."""
    from corrifnet_tpu.config import ExperimentConfig as JaxConfig
    from corrifnet_tpu.run.main import _build_model
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import main
    from corrifnet_tpu_torch.run.profile import meta_model

    value = LEVERS[field]

    def create(model_name, **kwargs):
        raise Built(model_name, kwargs)

    monkeypatch.setattr(main, "create_model", create)
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "modeltype": name, field: value}))
    with pytest.raises(Built) as built:
        main.main(["--config", "cfg.json", "--device", "cpu"])
    kwargs = built.value.args[1]
    assert kwargs[field] == value

    jax_model, _ = _build_model(JaxConfig(modeltype=name, **{field: value}))
    takes = field in get_spec(name).options
    assert takes == hasattr(jax_model, field)
    if not takes:
        return
    assert getattr(jax_model, field) == value
    model = meta_model(name, **{field: kwargs[field]})
    dec = model.decoder_fuse
    got = {"depth_mode": "pruned" if dec.pruned else "full",
           "decoder_remat": dec.remat_convs, "decoder_chunk": dec.c2_chunks}
    if field == "fuse_expand_bn":
        got[field] = all(b.fuse_expand_bn for enc in ("RGB", "NIR", "SWIR")
                         for b in getattr(model, f"{enc}_encoder").modules()
                         if hasattr(b, "fuse_expand_bn"))
    assert got[field] == value
