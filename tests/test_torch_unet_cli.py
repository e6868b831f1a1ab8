"""UNetV2, and with it the 4-D input path, through the port's two entry
points, on the CPU.

* ``run.main`` with ``modeltype`` UNetV2 and ``chindex`` 1 trains on the
  modality that the JAX package's ``_prepare_images`` picks (NIR) and on
  channel 0 of the masks, writes its run directory with the curves and no
  segplot (5-D models only, as in JAX), and ``notr`` re-initializes the 19
  conv kernels that the JAX package does;
* ``prepare_images`` picks as JAX's does for every ``chindex`` (an
  unreadable or out-of-range one means modality 0);
* ``run.evaluate`` of that run's final weights takes modality 0 whatever
  ``chindex`` says, as the JAX package's ``evaluate_run`` does, and gives
  JAX's probabilities on those images;
* ``load_weights`` drops a reference ``.pt``'s dead ConvTranspose2d weights
  and BatchNorm step counters;
* what the port refuses stays refused.
"""

from __future__ import annotations

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import create_model
from torch_levers import LEVERS, check_entry_points_take
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
OTHERS = ("MMVit4", "RobustMseg", "MultiSenseSeg")


def _record_inputs(monkeypatch, module, inputs):
    """``module.create_model`` with a hook that keeps each forward's input."""
    build = module.create_model

    def create(*args, **kwargs):
        model = build(*args, **kwargs)
        model.register_forward_hook(lambda m, a, out: inputs.append(
            (a[0].detach().clone(), out.detach().clone())))
        return model

    monkeypatch.setattr(module, "create_model", create)


def test_training_entry_point_runs_unet_on_the_chosen_modality(tmp_path, monkeypatch):
    """``run.main`` on the CPU with ``modeltype`` UNetV2, ``chindex`` 1, f32,
    15 synthetic patches, one epoch of batch 4 (3 steps, 1 validation
    patch, 3 test patches): every batch the model sees is NIR, as JAX's
    ``_prepare_images`` picks, the masks channel 0 (the epoch's training
    loss is recomputed from them); the log files, both checkpoints,
    the summary and the curve PNGs are written and no segplot; the 19
    re-initialized kernels; then ``run.evaluate`` of the final checkpoint
    with the same config takes RGB (modality 0) whatever ``chindex`` says,
    and matches JAX's ``UNetV2.apply`` on those images."""
    from corrifnet_tpu.models.unet import UNetV2
    from corrifnet_tpu.run.main import _prepare_images
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.models.registry import get_spec
    from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
    from corrifnet_tpu_torch.run import evaluate
    from corrifnet_tpu_torch.run import main as run_main
    from corrifnet_tpu_torch.train import Checkpointer, masked_loss_and_jaccard

    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "fno": 2, "fsiz": 5, "n_epochs": 1, "modeltype": "UNetV2",
         "chindex": "1", "synthetic_seed": 0, "dtype": "float32"}))
    seen = []
    _record_inputs(monkeypatch, run_main, seen)
    r = run_main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])

    tsind, trind, vlind = data.cross_val(15, 2, 5)
    arrays = data.load_dstl(15, trind, synthetic_seed=0)
    jax_spec = type("Spec", (), {"input_kind": "4d"})
    nir = _prepare_images(arrays.images, jax_spec, "1")
    assert np.array_equal(nir, arrays.images[:, 1])
    # the training batches, the validation (on a copy, hook and all), the test
    assert len(seen) == 3 + 1 + 1
    for i, (x, _) in enumerate(seen[:3]):
        idx = trind[4 * i:4 * i + 4]
        assert x.shape[1:] == (3, 224, 224)
        np.testing.assert_array_equal(x[:len(idx)].numpy(), nir[idx])
    np.testing.assert_array_equal(seen[3][0][:1].numpy(), nir[vlind])
    np.testing.assert_array_equal(seen[4][0][:3].numpy(), nir[tsind])
    # the epoch's training loss, from the steps' outputs and channel 0 of the masks
    losses = []
    for i, (_, out) in enumerate(seen[:3]):
        idx = trind[4 * i:4 * i + 4]
        masks = np.zeros((4, 1, 224, 224), np.float32)
        masks[:len(idx)] = arrays.masks[idx, 0]
        valid = (np.arange(4) < len(idx)).astype(np.float32)
        assert out.shape == (4, 1, 224, 224)
        losses.append(float(masked_loss_and_jaccard(out, torch.from_numpy(masks),
                                                    torch.from_numpy(valid))[0]))
    assert np.mean(losses) == pytest.approx(r["history"]["train_loss"][0], rel=1e-6)

    run_dir = tmp_path / r["run_dir"]
    for name in ("trainFile", "trainaccFile", "trainepochFile", "valFile", "valaccFile",
                 "testFile", "testaccFile", "fpsfile"):
        assert len((run_dir / f"{name}.txt").read_text().splitlines()) == 1, name
    assert r["train_steps"] == 3
    for loss in (r["history"]["train_loss"][0], r["history"]["val_loss"][0],
                 r["test_loss"]):
        assert 0.5 <= loss <= 1.0
    summary = next(run_dir.glob("2*_*.txt")).read_text()
    assert "Model version:UNetV2" in summary and "Channel index:1" in summary
    assert not list(run_dir.glob("*image*.png")) and not list(run_dir.glob("*mask*.png"))
    if importlib.util.find_spec("matplotlib") is not None:
        for name in ("learning_curves", "accuracy_curves"):
            assert (run_dir / f"{name}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    ckpt = Checkpointer(run_dir)
    final = ckpt.restore("Finaliremmodel0")
    assert sorted(final) == sorted(create_model("UNetV2").state_dict())
    reinit = apply_reference_init_scheme(create_model("UNetV2"), "kaiming_normal_",
                                         run_main.scheme_generator(0))
    assert len(reinit) == 19

    seen.clear()
    _record_inputs(monkeypatch, evaluate, seen)
    res = evaluate.main(["--config", "cfg.json", "--weights",
                         str(run_dir / "Finaliremmodel0"), "--device", "cpu"])
    assert res["n_images"] == 3 and len(seen) == 1
    rgb = arrays.images[tsind, 0]
    np.testing.assert_array_equal(seen[0][0][:3].numpy(), rgb)
    assert get_spec("UNetV2").input_kind == "4d"
    want = np.asarray(jax.jit(lambda v, xx: UNetV2(dtype=jnp.float32).apply(v, xx, False))(
        ti.unetv2_variables_from_state_dict(final), jnp.asarray(rgb)))
    err = np.abs(seen[0][1][:3].numpy() - want).max()
    print("UNetV2 through run.evaluate against JAX:", err)
    assert err <= MODEL_ATOL, err
    for other in OTHERS:
        with pytest.raises(ValueError, match=f"UNetV2 weights, not {other}"):
            evaluate.load_weights(run_dir / "Finaliremmodel0", other)


@pytest.mark.parametrize("chindex", ["0", "1", "2", "3", "-1", "x", None])
def test_prepare_images_picks_as_jax(chindex):
    """``run.main.prepare_images`` against JAX's ``_prepare_images``: a 4-D
    model gets the modality ``chindex`` names, modality 0 where it is not
    an integer or out of range; a 5-D model gets all three."""
    from corrifnet_tpu.run.main import _prepare_images
    from corrifnet_tpu_torch.models.registry import get_spec
    from corrifnet_tpu_torch.run.main import prepare_images

    images = np.random.default_rng(0).normal(0, 1, (2, 3, 3, 4, 4)).astype(np.float32)
    for name in ("UNetV2", "MultiSenseSeg"):
        spec = get_spec(name)
        want = _prepare_images(images, type("Spec", (), {"input_kind": spec.input_kind}),
                               chindex)
        got = prepare_images(images, spec, chindex)
        assert got.shape == want.shape and np.array_equal(got, want)


def test_load_weights_reads_a_reference_pt(tmp_path):
    """A reference UNetV2 ``.pt`` (the dead ``up{i}.up`` ConvTranspose2d
    weights, BatchNorm's ``num_batches_tracked``) loads into the port."""
    from corrifnet_tpu_torch.run.evaluate import load_weights

    model = create_model("UNetV2", seed=2)
    sd = dict(model.state_dict())
    for i in range(1, 5):
        sd[f"up{i}.up.weight"] = torch.zeros(4, 4, 2, 2)
        sd[f"up{i}.up.bias"] = torch.zeros(4)
    for key in list(sd):
        if key.endswith(".running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(1)
    torch.save(sd, tmp_path / "ref.pt")
    loaded = load_weights(tmp_path / "ref.pt", "UNetV2")
    create_model("UNetV2").load_state_dict(loaded, strict=True)
    assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())


_REFUSED = {"fuse_expand_bn": True, "depth_mode": "pruned", "decoder_chunk": 2,
            "decoder_remat": True, "mesh_shape": [1, 1], "use_pallas": False}


@pytest.mark.parametrize("field", sorted(_REFUSED))
def test_entry_points_refuse(field, tmp_path, monkeypatch, capsys):
    """MMVit4's four levers are taken by both entry points and have no
    effect on UNetV2 (``torch_levers``). What the port still refuses
    stays refused with UNetV2: both entry points
    raise naming the field before anything is built (``use_pallas=False``
    on a CUDA device only, asked of ``run.evaluate`` alone)."""
    if field in LEVERS:
        check_entry_points_take("UNetV2", field, _REFUSED[field], tmp_path,
                                monkeypatch, capsys)
        return
    from corrifnet_tpu_torch.run import evaluate, main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "modeltype": "UNetV2",
         field: _REFUSED[field]}))
    on_card = field == "use_pallas"
    for run in (evaluate.main,) if on_card else (main.main, evaluate.main):
        with pytest.raises(NotImplementedError, match=rf"{field}=.*ROADMAP\.md"):
            run(["--config", "cfg.json", "--device", "cuda" if on_card else "cpu"])
