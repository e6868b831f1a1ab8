"""A 4-D zoo model through the port's two entry points, on the CPU.

Shared by the 4-D zoo models' CLI test files (``tests/test_torch_*_cli.py``
of Segformer, DeepLabv3_plus, ELANet, FASSDNet and ENet):
``train_then_evaluate`` runs ``run.main`` on 15 synthetic patches (one
epoch of batch 4: 3 steps, 1 validation patch, 3 test patches) with the
model's ``chindex``, holds every
batch the model saw to the modality JAX's ``_prepare_images`` picks and the
epoch's training loss to the masks' channel 0, checks the run directory (no
segplot for a 4-D model), then runs ``run.evaluate`` of the final
checkpoint, which takes modality 0 whatever ``chindex`` says, and holds its
probabilities to JAX's on those images. The training run flushes denormal
floats to zero on the CPU: the ``notr`` re-initialization saturates
Segformer's sigmoid, whose backward then runs on denormal gradients about
eight times slower (a step 49 s instead of 6 s on 2 threads), and no value
that is checked depends on them. ``weights_files`` writes a model's
weights as a JAX ``.npz`` and as a reference-layout ``.pt`` for
``load_weights``.
"""

from __future__ import annotations

import importlib.util
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu_torch.models import create_model

MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
# BCEWithLogits of a probability, the reference's double sigmoid: the loss of
# any output lies in [log(1 + e^-1), log(1 + e)]. DeepLabv3_plus's eval-mode
# losses, on running statistics that moved for three steps, sit near the top
DOUBLE_SIGMOID = (math.log1p(math.exp(-1.0)), math.log1p(math.e))


def record_inputs(monkeypatch, module, inputs):
    """``module.create_model`` with a hook that keeps each forward's input
    and output."""
    build = module.create_model

    def create(*args, **kwargs):
        model = build(*args, **kwargs)
        model.register_forward_hook(lambda m, a, out: inputs.append(
            (a[0].detach().clone(), out.detach().clone())))
        return model

    monkeypatch.setattr(module, "create_model", create)


def train_then_evaluate(tmp_path, monkeypatch, name, chindex, jax_model, to_variables,
                        notr_kernels, witness=False):
    """The checks above for ``name`` trained on modality ``chindex``;
    ``jax_model()`` is the JAX module and ``to_variables`` the JAX
    package's converter of its ``state_dict``. With ``witness``, the
    probabilities are held to the larger of MODEL_ATOL and twice what the
    port's own change under a 1e-6 change of the input, as the whole-model
    checks are (ENet's trained weights amplify f32 rounding: that change
    moves its probabilities by 8e-5, and the port and JAX are each as far
    from float64). Returns the final checkpoint's state_dict."""
    from corrifnet_tpu.run.main import _prepare_images
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.models.registry import get_spec
    from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
    from corrifnet_tpu_torch.run import evaluate
    from corrifnet_tpu_torch.run import main as run_main
    from corrifnet_tpu_torch.train import Checkpointer, masked_loss_and_jaccard

    assert get_spec(name).input_kind == "4d"
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "fno": 2, "fsiz": 5, "n_epochs": 1, "modeltype": name,
         "chindex": chindex, "synthetic_seed": 0, "dtype": "float32"}))
    seen = []
    record_inputs(monkeypatch, run_main, seen)
    flushed = torch.set_flush_denormal(True)
    try:
        r = run_main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])
    finally:
        torch.set_flush_denormal(False)
    assert flushed

    tsind, trind, vlind = data.cross_val(15, 2, 5)
    arrays = data.load_dstl(15, trind, synthetic_seed=0)
    chosen = _prepare_images(arrays.images, type("Spec", (), {"input_kind": "4d"}), chindex)
    assert np.array_equal(chosen, arrays.images[:, int(chindex)])
    # the training batches, the validation (on a copy, hook and all), the test
    assert len(seen) == 3 + 1 + 1
    losses = []
    for i, (x, out) in enumerate(seen[:3]):
        idx = trind[4 * i:4 * i + 4]
        assert x.shape[1:] == (3, 224, 224) and out.shape == (4, 1, 224, 224)
        np.testing.assert_array_equal(x[:len(idx)].numpy(), chosen[idx])
        masks = np.zeros((4, 1, 224, 224), np.float32)
        masks[:len(idx)] = arrays.masks[idx, 0]
        valid = (np.arange(4) < len(idx)).astype(np.float32)
        losses.append(float(masked_loss_and_jaccard(out, torch.from_numpy(masks),
                                                    torch.from_numpy(valid))[0]))
    np.testing.assert_array_equal(seen[3][0][:1].numpy(), chosen[vlind])
    np.testing.assert_array_equal(seen[4][0][:3].numpy(), chosen[tsind])
    assert np.mean(losses) == pytest.approx(r["history"]["train_loss"][0], rel=1e-6)

    run_dir = tmp_path / r["run_dir"]
    for log in ("trainFile", "trainaccFile", "trainepochFile", "valFile", "valaccFile",
                "testFile", "testaccFile", "fpsfile"):
        assert len((run_dir / f"{log}.txt").read_text().splitlines()) == 1, log
    assert r["train_steps"] == 3
    for loss in (r["history"]["train_loss"][0], r["history"]["val_loss"][0], r["test_loss"]):
        assert DOUBLE_SIGMOID[0] <= loss <= DOUBLE_SIGMOID[1], loss
    summary = next(run_dir.glob("2*_*.txt")).read_text()
    assert f"Model version:{name}" in summary and f"Channel index:{chindex}" in summary
    assert not list(run_dir.glob("*image*.png")) and not list(run_dir.glob("*mask*.png"))
    if importlib.util.find_spec("matplotlib") is not None:
        for curve in ("learning_curves", "accuracy_curves"):
            assert (run_dir / f"{curve}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    final = Checkpointer(run_dir).restore("Finaliremmodel0")
    assert sorted(final) == sorted(create_model(name).state_dict())
    reinit = apply_reference_init_scheme(create_model(name), "kaiming_normal_",
                                         run_main.scheme_generator(0))
    assert len(reinit) == notr_kernels

    seen.clear()
    record_inputs(monkeypatch, evaluate, seen)
    res = evaluate.main(["--config", "cfg.json", "--weights",
                         str(run_dir / "Finaliremmodel0"), "--device", "cpu"])
    assert res["n_images"] == 3 and len(seen) == 1
    rgb = arrays.images[tsind, 0]
    np.testing.assert_array_equal(seen[0][0][:3].numpy(), rgb)
    want = np.asarray(jax.jit(lambda v, xx: jax_model().apply(v, xx, False))(
        to_variables(final), jnp.asarray(rgb)))
    err = np.abs(seen[0][1][:3].numpy() - want).max()
    bound = MODEL_ATOL
    if witness:
        model = create_model(name)
        model.load_state_dict(final)
        with torch.no_grad():
            moved = (model(torch.from_numpy(rgb * np.float32(1 + 1e-6)))
                     - model(torch.from_numpy(rgb))).abs().max().item()
        bound = max(MODEL_ATOL, 2 * moved)
    print(f"{name} through run.evaluate against JAX:", err, "bound:", bound)
    assert err <= bound, (err, bound)
    return final


def weights_files(tmp_path, name, to_variables, seed=2):
    """(model, .npz of its JAX variables, a reference ``.pt`` of its
    state_dict with BatchNorm's ``num_batches_tracked``)."""
    from corrifnet_tpu_torch.models.jax_import import flatten_variables

    model = create_model(name, seed=seed)
    sd = dict(model.state_dict())
    np.savez(tmp_path / "w.npz", **flatten_variables(to_variables(sd)))
    for key in list(sd):
        if key.endswith(".running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(1)
    torch.save(sd, tmp_path / "ref.pt")
    return model, tmp_path / "w.npz", tmp_path / "ref.pt"
