"""The port's fused-bottleneck configuration (``pallas_fused_blocks``) against
the JAX package, on the CPU, where the port's fused convolutions run their
plain versions.

* ``Bottleneck3D(pallas_fused=True)`` against the JAX block with
  ``pallas_fused=True`` (its Pallas kernels in interpret mode) and against
  the port's own standard block: train output, running statistics after one
  step, eval output, gradients of parameters and input; the ``state_dict``
  is the same with the flag on and off;
* ``MMVit4(pallas_fused_blocks=True)`` against the JAX model with the same
  flag at 64x64, B=1, f32: eval output, and one train-mode forward's loss
  and running statistics;
* both entry points honour the flag and refuse by name the config fields
  the port does not honour.
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrifnet_tpu.ops.fusedconv as jax_fc
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch import ops
from corrifnet_tpu_torch.models import create_model
from corrifnet_tpu_torch.models.resnet3d import Bottleneck3D
from corrifnet_tpu_torch.testing import calibrate_batchnorm
from torch_levers import LEVERS, check_entry_points_take
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# the JAX suite's bounds for the fused block against the standard one
# (tests/test_pallas_block.py:50-60,86-93): f32 sums in another order
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
WIDTH = 8
_BLOCK_CASES = [(1, False), (1, True), (2, True)]


def _normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def _cl(x):
    return np.moveaxis(x, 1, -1)


def _block_pair(stride, down, seed=25):
    """The same weights in a standard and a fused port block, with random
    BatchNorm affines and running statistics."""
    cin = WIDTH * (2 if down else 4)
    blocks = []
    for fused in (False, True):
        blk = Bottleneck3D(cin, WIDTH, stride, down, pallas_fused=fused)
        gen = torch.Generator().manual_seed(seed)
        for m in blk.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        blocks.append(blk)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, buf in blocks[0].state_dict().items():
            if name.endswith(("bn1.weight", "bn2.weight", "bn3.weight", "1.weight")):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
            elif name.endswith("bias"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.1, buf.shape).astype(np.float32)))
            elif name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.2, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, buf.shape).astype(np.float32)))
    blocks[1].load_state_dict(blocks[0].state_dict(), strict=True)
    return blocks[0], blocks[1], _normal((2, cin, 3, 12, 12), seed + 2)


def _jax_block(blk, stride, down):
    from corrifnet_tpu.models.resnet3d import Bottleneck3D as JB

    sd = {f"b.{k}": v for k, v in blk.state_dict().items()}
    params, stats = ti._bottleneck(sd, "b", down)
    return JB(width=WIDTH, stride=stride, has_downsample=down, pallas_fused=True), \
        {"params": params, "batch_stats": stats}


def _train_forward_and_grads(blk, x):
    """Train-mode output, and the gradients of sum(y * cos(index)) with
    respect to the parameters and the input."""
    blk.train()
    leaf = torch.from_numpy(x).requires_grad_()
    y = blk(leaf)
    weights = torch.cos(torch.arange(y.numel(), dtype=torch.float32))
    # the JAX side enumerates its channels-last output
    loss = (y.permute(0, 2, 3, 4, 1).reshape(-1) * weights).sum()
    names, params = zip(*blk.named_parameters())
    grads = torch.autograd.grad(loss, [leaf, *params])
    return y.detach(), grads[0], dict(zip(names, grads[1:]))


@pytest.mark.parametrize("stride,down", _BLOCK_CASES)
def test_fused_bottleneck_state_dict_is_the_standard_one(stride, down):
    std, fus, _ = _block_pair(stride, down)
    a, b = std.state_dict(), fus.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)


@pytest.mark.parametrize("stride,down", _BLOCK_CASES)
def test_fused_bottleneck_matches_jax(stride, down, monkeypatch):
    """Against the JAX fused block with its Pallas kernels in interpret mode."""
    monkeypatch.setattr(jax_fc, "INTERPRET", True)
    _, fus, x = _block_pair(stride, down)
    jm, variables = _jax_block(fus, stride, down)
    xj = jnp.asarray(_cl(x))

    want_eval = np.asarray(jm.apply(variables, xj, False))
    with torch.no_grad():
        got_eval = fus.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_cl(got_eval), want_eval, **BLOCK_TOL)

    def loss(params, xx):
        y, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          xx, True, mutable=["batch_stats"])
        return (y * jnp.cos(jnp.arange(y.size).reshape(y.shape))).sum(), (y, mut)

    (_, (want_y, mut)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], xj)
    got_y, got_gx, got_gp = _train_forward_and_grads(fus, x)
    np.testing.assert_allclose(_cl(got_y.numpy()), np.asarray(want_y), **BLOCK_TOL)
    np.testing.assert_allclose(_cl(got_gx.numpy()), np.asarray(gx), **BLOCK_TOL)

    # gradients and running statistics, in the port's names
    sd = {f"b.{k}": v for k, v in fus.state_dict().items()}
    for name, g in got_gp.items():
        sd[f"b.{name}"] = g
    got_params, got_stats = ti._bottleneck(sd, "b", down)
    for mod, leaves in gp.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(np.asarray(got_params[mod][leaf]), np.asarray(want),
                                       err_msg=f"{mod}.{leaf}", **BLOCK_TOL)
    for mod, leaves in mut["batch_stats"].items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(np.asarray(got_stats[mod][leaf]), np.asarray(want),
                                       err_msg=f"{mod}.{leaf}", **STATS_TOL)


@pytest.mark.parametrize("stride,down", _BLOCK_CASES)
def test_fused_bottleneck_matches_the_standard_block(stride, down):
    std, fus, x = _block_pair(stride, down)
    with torch.no_grad():
        np.testing.assert_allclose(fus.eval()(torch.from_numpy(x)).numpy(),
                                   std.eval()(torch.from_numpy(x)).numpy(), **BLOCK_TOL)
    y_s, gx_s, gp_s = _train_forward_and_grads(std, x)
    y_f, gx_f, gp_f = _train_forward_and_grads(fus, x)
    np.testing.assert_allclose(y_f.numpy(), y_s.numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(gx_f.numpy(), gx_s.numpy(), **BLOCK_TOL)
    for name in gp_s:
        np.testing.assert_allclose(gp_f[name].numpy(), gp_s[name].numpy(),
                                   err_msg=name, **BLOCK_TOL)
    for name, buf in std.state_dict().items():
        if "running_" in name:
            np.testing.assert_allclose(fus.state_dict()[name].numpy(), buf.numpy(),
                                       err_msg=name, **STATS_TOL)


def test_fused_bottleneck_output_is_channels_last_memory():
    """A chain of fused blocks copies its input into channels-last once:
    every block returns an NCDHW view of channels-last memory."""
    _, fus, x = _block_pair(1, False)
    with torch.no_grad():
        y = fus.eval()(torch.from_numpy(x))
    assert y.shape == x.shape and y.permute(0, 2, 3, 4, 1).is_contiguous()


# ---------------------------------------------------------------- whole model

# f32 whole-model forwards: the bound of tests/test_torch_mmvit4.py
MODEL_ATOL = 5e-5


@pytest.fixture(scope="module")
def fused_model_and_input():
    """The port's MMVit4 with the flag on, from seed 0, with the standard
    model's calibrated BatchNorm statistics (the calibration hooks run on
    ``BatchNorm.forward``, which the fused blocks do not call)."""
    std = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=0,
                       transformer_dropout=0.0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in std.named_parameters():
            if name.endswith("_pos"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    x = rng.normal(0, 1, (1, 3, 3, 64, 64)).astype(np.float32)
    calibrate_batchnorm(std, torch.from_numpy(x))
    fused = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=1,
                         transformer_dropout=0.0, pallas_fused_blocks=True)
    assert list(fused.state_dict()) == list(std.state_dict())
    fused.load_state_dict(std.state_dict(), strict=True)
    return fused, x


def _jax_fused_model():
    from corrifnet_tpu.models.mmvit4 import MMVit4 as JaxMMVit4

    return JaxMMVit4(dtype=jnp.float32, pallas_fused_blocks=True,
                     transformer_dropout=0.0)


def test_fused_model_runs_the_fused_kernels(fused_model_and_input, monkeypatch):
    """108 pointwise and 39 3x3 fused convolutions per forward: 16
    bottlenecks per encoder (4 with a projection, 3 with a stride-2 conv2),
    three encoders."""
    from corrifnet_tpu_torch.models import resnet3d

    model, x = fused_model_and_input
    calls = {"pw": 0, "c3": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(resnet3d, "pointwise_conv_stats",
                        counted("pw", ops.pointwise_conv_stats))
    monkeypatch.setattr(resnet3d, "conv3x3_fma_relu_stats",
                        counted("c3", ops.conv3x3_fma_relu_stats))
    with torch.no_grad():
        model.eval()(torch.from_numpy(x))
    assert calls == {"pw": 108, "c3": 39}


def test_fused_model_matches_jax(fused_model_and_input):
    from corrifnet_tpu.models.torch_import import mmvit4_variables_from_state_dict

    model, x = fused_model_and_input
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    variables = mmvit4_variables_from_state_dict(model.state_dict(), pack_stage1=True)
    jm = _jax_fused_model()
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False))(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        jnp.asarray(x)))
    assert got.shape == want.shape == (1, 3, 1, 224, 224) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=0)


def test_fused_model_train_forward_matches_jax(fused_model_and_input):
    """One train-mode forward (BatchNorm on batch statistics, dropout 0):
    the loss within 1e-5 and the running statistics within 2e-3 of each
    layer's largest variance (means: of its largest standard deviation), the
    bounds of test_train_step_matches_jax. Gradients are held at block level
    (whole-model f32 gradients at random initialization are badly
    conditioned)."""
    from corrifnet_tpu.models.torch_import import mmvit4_variables_from_state_dict
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard
    from corrifnet_tpu_torch.models import mmvit4_state_dict_from_variables
    from corrifnet_tpu_torch.train import masked_loss_and_jaccard

    model, x = fused_model_and_input
    start = {k: v.clone() for k, v in model.state_dict().items()}
    masks = (np.random.default_rng(3).random((1, 3, 1, 224, 224)) > 0.7).astype(np.float32)
    valid = np.ones(1, np.float32)
    variables = mmvit4_variables_from_state_dict(start, pack_stage1=True)
    jm = _jax_fused_model()

    def forward(v, xx, mm, vv):
        out, mut = jm.apply(v, xx, True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        loss, _, _ = _masked_loss_and_jaccard(out.astype(jnp.float32), mm, vv)
        return loss, mut["batch_stats"]

    loss_j, stats_j = jax.jit(forward)(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        *map(jnp.asarray, (x, masks, valid)))
    try:
        with torch.no_grad():
            out = model.train()(torch.from_numpy(x)).float()
            loss, _, _ = masked_loss_and_jaccard(out, torch.from_numpy(masks),
                                                 torch.from_numpy(valid))
        after = {k: v.clone() for k, v in model.state_dict().items()}
    finally:
        model.load_state_dict(start)
        model.eval()
    assert abs(loss.item() - float(loss_j)) <= 1e-5, (loss.item(), float(loss_j))
    after_j = mmvit4_state_dict_from_variables(
        {"params": variables["params"], "batch_stats": jax.tree.map(np.asarray, stats_j)})
    err = 0.0
    for name in after:
        if name.endswith("running_var"):
            scale = after_j[name].max().item()
            mean = name.replace("running_var", "running_mean")
            err = max(err, (after[name] - after_j[name]).abs().max().item() / scale,
                      (after[mean] - after_j[mean]).abs().max().item() / math.sqrt(scale))
    assert err <= 2e-3, err


def test_fused_model_backward_agrees_with_the_standard_model(fused_model_and_input):
    """One train-mode forward and backward of the whole model at 64x64 with
    the flag on against the flag off, same weights, dropout 0: the loss
    within 1e-5, gradients for the same parameters, and the whole gradient's
    cosine >= 0.97 (the bound of test_train_step_matches_jax: at random
    initialization f32 rounding moves this gradient by percents, so
    gradients are held tightly at block level)."""
    from corrifnet_tpu_torch.train import masked_loss_and_jaccard

    fused, x = fused_model_and_input
    start = {k: v.clone() for k, v in fused.state_dict().items()}
    std = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=1,
                       transformer_dropout=0.0)
    std.load_state_dict(start, strict=True)
    masks = torch.from_numpy(
        (np.random.default_rng(3).random((1, 3, 1, 224, 224)) > 0.7).astype(np.float32))
    results = []
    try:
        for model in (std, fused):
            model.train().zero_grad(set_to_none=True)
            out = model(torch.from_numpy(x)).float()
            loss, _, _ = masked_loss_and_jaccard(out, masks, torch.ones(1))
            loss.backward()
            results.append((loss.item(), {n: p.grad.clone() for n, p in
                                          model.named_parameters() if p.grad is not None}))
    finally:
        fused.load_state_dict(start)
        fused.eval().zero_grad(set_to_none=True)
    (loss_s, g_s), (loss_f, g_f) = results
    assert abs(loss_s - loss_f) <= 1e-5, (loss_s, loss_f)
    assert sorted(g_s) == sorted(g_f)
    assert all(bool(torch.isfinite(g).all()) for g in g_f.values())
    dot = sum(float((g_s[n] * g_f[n]).sum()) for n in g_s)
    norms = math.sqrt(sum(float(g.square().sum()) for g in g_s.values())
                      * sum(float(g.square().sum()) for g in g_f.values()))
    assert dot / norms >= 0.97, dot / norms


# ---------------------------------------------------------------- entry points


_REFUSED = {
    "fuse_expand_bn": True, "depth_mode": "pruned",
    "decoder_chunk": 2, "decoder_remat": True, "mesh_shape": [1, 1],
}
_RUN_LEVEL = {"extended_checkpoints": True, "transfer_checkpoint": "some/dir"}


@pytest.mark.parametrize("entry", ["main", "evaluate"])
@pytest.mark.parametrize("field", sorted(_REFUSED))
def test_entry_points_refuse_fields_the_port_does_not_honour(field, entry, tmp_path,
                                                             monkeypatch, capsys):
    """``mesh_shape`` is refused by name before anything is built (no
    permutation file exists here, so reaching the data would raise another
    error). MMVit4's four levers, refused before they were ported, are now
    taken: ``run.main`` builds the model with the field, ``run.evaluate``
    without it, naming it on one line (``torch_levers``)."""
    if field in LEVERS:
        check_entry_points_take("MMVit4", field, _REFUSED[field], tmp_path, monkeypatch,
                                capsys, entries=(entry,))
        return
    from corrifnet_tpu_torch.run import evaluate, main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, field: _REFUSED[field]}))
    run = main.main if entry == "main" else evaluate.main
    with pytest.raises(NotImplementedError, match=rf"{field}=.*ROADMAP\.md"):
        run(["--config", "cfg.json", "--device", "cpu"])


@pytest.mark.parametrize("entry", ["main", "evaluate"])
@pytest.mark.parametrize("field", sorted(_RUN_LEVEL))
def test_entry_points_accept_run_level_fields(field, entry, tmp_path, monkeypatch):
    """Both entry points take ``extended_checkpoints`` and
    ``transfer_checkpoint`` and go on to build the model (the run stops
    there); ``run.evaluate`` ignores both, as the JAX evaluation does, and
    ``run.main`` reads ``transfer_checkpoint`` only with ``transfertype``
    ``yestr`` (here the default ``notr``)."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import evaluate, main

    class Built(Exception):
        pass

    def create(name, **kwargs):
        raise Built(name)

    mod = main if entry == "main" else evaluate
    monkeypatch.setattr(mod, "create_model", create)
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, field: _RUN_LEVEL[field]}))
    with pytest.raises(Built, match="MMVit4"):
        mod.main(["--config", "cfg.json", "--device", "cpu"])


def test_check_supported_accepts_defaults_and_names_inert_fields(capsys):
    from corrifnet_tpu_torch.config import ExperimentConfig, check_supported

    check_supported(ExperimentConfig(), "cuda")
    assert capsys.readouterr().out == ""
    check_supported(ExperimentConfig(use_pallas=False, decoder_lean=False,
                                     pallas_fused_blocks=True), "cpu")
    with pytest.raises(NotImplementedError, match="use_pallas=False"):
        check_supported(ExperimentConfig(use_pallas=False), "cuda:0")
    check_supported(ExperimentConfig(chain_steps=4, remat_mode="mid", scan_unroll=0,
                                     auto_layout=True), "cpu")
    line = capsys.readouterr().out
    assert line.count("\n") == 1
    assert all(f in line for f in ("chain_steps", "scan_unroll", "auto_layout",
                                   "no effect"))
    # remat_mode is honoured (run.main gives it to MMVit4), so never named
    assert "remat_mode" not in line


@pytest.mark.parametrize("fused", [False, True])
def test_training_entry_point_passes_the_flag_to_the_model(fused, tmp_path, monkeypatch):
    """``run.main`` builds the model with ``cfg.pallas_fused_blocks``. The
    run stops there: a fused training run at full width costs minutes on the
    CPU and is driven on the GPU by chip_smoke.py; the fused train step is
    held against JAX above, at model and block level."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import main

    class Built(Exception):
        pass

    def create(name, **kwargs):
        raise Built(name, kwargs)

    monkeypatch.setattr(main, "create_model", create)
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "dtype": "float32",
         "pallas_fused_blocks": fused}))
    with pytest.raises(Built) as built:
        main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])
    name, kwargs = built.value.args
    assert name == "MMVit4" and kwargs["pallas_fused_blocks"] is fused
    assert kwargs["dtype"] == torch.float32


def test_evaluation_entry_point_runs_the_fused_configuration_on_cpu(tmp_path, monkeypatch):
    """``run.evaluate`` on the CPU with ``pallas_fused_blocks``: one padded
    B=8 forward over the 3 test patches of 15, every bottleneck through the
    fused convolutions."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.models import resnet3d
    from corrifnet_tpu_torch.run import evaluate

    calls = []
    real = ops.pointwise_conv_stats
    monkeypatch.setattr(resnet3d, "pointwise_conv_stats",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "dtype": "float32",
         "pallas_fused_blocks": True}))
    e = evaluate.main(["--config", "cfg.json", "--device", "cpu"])
    assert e["n_images"] == 3 and len(calls) == 108 and 0.0 <= e["jaccard_mean"] <= 1.0
