"""The whole MMVit4 train step of the port against the JAX package in f32
on the CPU, shared by the test files that run it at one batch each
(``test_torch_train.py`` at B=1, ``test_torch_train_b4.py`` at B=4 with a
padded sample): two files, so that a test run that gives each file to one
worker runs the two cases side by side.

Import ``jax_step`` into a test module to get the fixture there; the module
names the decoder's lean setting of both sides in ``DECODER_LEAN`` (None:
the lean backward at batch <= 4, the default of both packages).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
# Imported while the test modules are collected, before any test runs: an
# optimizer's constructor imports it lazily, and that import reads every
# module's __file__ (inspect.getmodule), which a module stand-in installed
# into sys.modules by another test of the suite answers with a function.
import torch._dynamo  # noqa: F401

LR = 1e-4


@pytest.fixture(scope="module")
def jax_step(request):
    """One jitted JAX value_and_grad of the MMVit4 train loss (depth-fused
    decoder, lean as the test module's ``DECODER_LEAN``, XLA paths, dropout
    0), shared by the step tests."""
    from corrifnet_tpu.models.mmvit4 import MMVit4 as JaxMMVit4
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard

    jm = JaxMMVit4(dtype=jnp.float32, use_pallas=False,
                   decoder_lean=request.module.DECODER_LEAN, transformer_dropout=0.0)

    def loss_fn(params, batch_stats, images, masks, valid):
        out, mut = jm.apply({"params": params, "batch_stats": batch_stats}, images,
                            True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        loss, jac, _ = _masked_loss_and_jaccard(out.astype(jnp.float32), masks, valid)
        return loss, (mut["batch_stats"], jac)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _step_inputs(batch, padded):
    rng = np.random.default_rng(130 + batch)
    x = rng.normal(0, 1, (batch, 3, 3, 64, 64)).astype(np.float32)
    masks = (rng.random((batch, 3, 1, 224, 224)) > 0.7).astype(np.float32)
    valid = np.ones(batch, np.float32)
    if padded:  # as batch_iterator pads a ragged final batch
        x[-1], masks[-1], valid[-1] = 0.0, 0.0, 0.0
    return x, masks, valid


def _agreement(got, want):
    """(cosine over all tensors, worst per-tensor ||got - want|| / ||want||)."""
    dot = sum(float((got[n] * want[n]).sum()) for n in want)
    norms = math.sqrt(sum(float((got[n] ** 2).sum()) for n in want)
                      * sum(float((want[n] ** 2).sum()) for n in want))
    worst = max(float(np.linalg.norm(got[n] - want[n])
                      / max(np.linalg.norm(want[n]), 1e-30)) for n in want)
    return dot / norms, worst


def check_train_step(jax_step, batch, padded, decoder_lean):
    """One whole MMVit4 train step at 64x64 in f32, BatchNorm on batch
    statistics, dropout 0, then a second step after Adam, against JAX
    (use_pallas=False) with the same weights and batch, both sides with the
    decoder's lean setting ``decoder_lean``.

    Bounds. The first step's loss: 1e-5 (the second step's: 1e-3). The
    gradients: cosine of the whole gradient >= 0.97 and every tensor within
    0.4 of its norm. They are not held to f32 rounding (2e-4 of each
    tensor's largest entry), because at random initialization this gradient
    is badly conditioned: some forty ReLU+normalization layers in sequence
    amplify rounding, and the port's OWN gradients move by 20 to 40 percent
    of a tensor's largest entry when the input is scaled by 1 + 1e-6
    (measured; recorded in ROADMAP Queue 3, N1). Measured port against JAX:
    first loss 4e-7; B=1 cosine 0.9990, worst tensor 0.074 of its norm; B=4
    with a padded sample cosine 0.9850, worst tensor 0.24. The head, where
    nothing has been amplified yet, is held tight: final_conv's bias
    gradient within 2e-4 of its largest entry (measured 4e-6 and 9e-5).
    Every kernel module's own backward is held to f32 bounds above.

    After two Adam steps (lr 1e-4) no entry moved by more than 2e-4, the
    update directions agree (cosine >= 0.75; measured 0.90 and 0.86: Adam
    turns every gradient entry, however small and noisy, into a step of
    about lr) (after two steps the loss and the statistics of the deep
    layers carry those steps' differences). The running statistics are
    compared after the first step: within 2e-3 of each layer's largest
    variance (means: of its largest standard deviation); the update rule
    itself is held to 1e-6 in test_batchnorm_train_matches_jax."""
    from corrifnet_tpu.models.torch_import import mmvit4_variables_from_state_dict
    from corrifnet_tpu_torch.models import (
        create_model, mmvit4_named_gradients, mmvit4_state_dict_from_variables)
    from corrifnet_tpu_torch.testing import calibrate_batchnorm
    from corrifnet_tpu_torch.train import init_state, make_train_step

    x, masks, valid = _step_inputs(batch, padded)
    # remat_mode changes no bit (tests/test_torch_remat.py); "none" spares
    # the CPU the default's recompute of the encoders' tail blocks
    model = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=0,
                         transformer_dropout=0.0, decoder_lean=decoder_lean,
                         remat_mode="none")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_pos"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    calibrate_batchnorm(model, torch.from_numpy(x))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    variables = mmvit4_variables_from_state_dict(start, pack_stage1=True)
    params, stats = variables["params"], variables["batch_stats"]
    batch_j = tuple(map(jnp.asarray, (x, masks, valid)))

    state = init_state(model, "Adam")
    step = make_train_step(state)
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    opt_state = adam.init(params)
    first_grads = None
    for i in range(2):
        (loss_j, (stats, jac_j)), grads = jax_step(params, stats, *batch_j)
        updates, opt_state = adam.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p - LR * u, params, updates)
        metrics = step(*map(torch.from_numpy, (x, masks, valid)), LR)
        loss, jac, n_valid = metrics.tolist()
        # the second step starts from parameters that Adam moved by +-lr
        # along noisy gradient signs: measured 9e-5 and 1.9e-4
        assert abs(loss - float(loss_j)) <= (1e-5, 1e-3)[i], (i, loss, float(loss_j))
        assert abs(jac - float(jac_j)) <= (1e-4, 1e-3)[i]
        assert n_valid == valid.sum()
        if first_grads is None:
            want = {k: v.numpy() for k, v in mmvit4_named_gradients(
                jax.tree.map(np.asarray, grads)).items()}
            got = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                   if p.grad is not None}
            # parameters without a gradient here (fusion5, unused) have none in JAX
            assert all(np.abs(want[n]).max() == 0 for n in want if n not in got)
            first_grads = (got, {n: want[n] for n in got})
            first_stats = ({k: v.clone() for k, v in model.state_dict().items()
                            if "running_" in k}, jax.tree.map(np.asarray, stats))
    assert state.step == 2

    got, want = first_grads
    cosine, worst = _agreement(got, want)
    head = "decoder_fuse.final_conv.bias"
    head_err = np.abs(got[head] - want[head]).max() / np.abs(want[head]).max()

    after_j = mmvit4_state_dict_from_variables(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, stats)})
    after = model.state_dict()
    moved = {n: (after[n] - start[n]).numpy() for n in got}
    moved_j = {n: (after_j[n] - start[n]).numpy() for n in got}
    assert max(np.abs(m).max() for m in moved.values()) <= 2 * LR * 1.001
    update_cosine, _ = _agreement(moved, moved_j)
    measured = dict(cosine=cosine, worst=worst, head=head_err, update=update_cosine)
    print("train step against JAX:", batch, measured)
    assert cosine >= 0.97 and worst <= 0.4, measured
    assert head_err <= 2e-4, measured
    assert update_cosine >= 0.75, measured
    # running statistics after the first step, in units of the layer's
    # largest variance (means: of its largest standard deviation)
    buffers, stats_j = first_stats
    buffers_j = mmvit4_state_dict_from_variables(
        {"params": variables["params"], "batch_stats": stats_j})
    stats_err = 0.0
    for name, buf in buffers.items():
        if name.endswith("running_var"):
            var_scale = buffers_j[name].max().item()
            mean_name = name.replace("running_var", "running_mean")
            stats_err = max(
                stats_err, (buf - buffers_j[name]).abs().max().item() / var_scale,
                (buffers[mean_name] - buffers_j[mean_name]).abs().max().item()
                / math.sqrt(var_scale))
    print("running statistics after one step:", stats_err)
    assert stats_err <= 2e-3, stats_err
