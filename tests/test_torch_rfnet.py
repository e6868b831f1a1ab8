"""The port's RFNet against the JAX package, on the CPU in f32.

The JAX side gets the port's weights through
``corrifnet_tpu.models.torch_import.rfnet_variables_from_state_dict`` (its
eager ``init`` takes minutes here; its abstract shapes come from
``jax.eval_shape``). RFNet's cascade runs at fixed volumes (16^3 to 128^3,
then 1x224x224) whatever the input, so a 64x64 input runs every path of the
224x224 model:

* the whole forward at B=1;
* one training step: the loss and the gradients to N1's bounds, the region
  map generators' parameters without gradient (JAX: exactly zero);
* the ``state_dict`` both ways through the JAX converter, bit for bit, with
  the leaf and parameter counts;
* a ``TrainState`` whose generators have no Adam state round-trips through
  its checkpoint and steps on as the original does.
"""

from __future__ import annotations

import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import (
    create_model,
    rfnet_named_gradients,
    rfnet_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.train import init_state, make_train_step
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_step import hold_step

RFNET_PARAMS = 1_635_369  # the JAX init tree's (jax.eval_shape)
RFNET_TENSORS = 196  # the port's state_dict
JAX_LEAVES = 148  # the three encoders' 3 x 24 leaves stacked into 24
MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
# every gradient tensor's ||port - JAX|| / ||JAX|| (test_train_step_matches_jax)
TENSOR_BOUND = 0.05


def _jax_model():
    from corrifnet_tpu.models.rfnet import RFNet

    return RFNet(dtype=jnp.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, 3, 3, 64, 64)).astype(np.float32)
    masks = (rng.random((1, 3, 1, 224, 224)) > 0.7).astype(np.float32)
    return x, masks, np.ones(1, np.float32)


def test_whole_model_matches_jax():
    """B=1, 64x64, f32: the probabilities within MODEL_ATOL, or twice the
    port's own change under a 1e-6 change of the input where that is
    larger. Measured: 5.3e-6."""
    model = create_model("RFNet", seed=0)
    x, _, _ = _inputs(11)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        witness = (model(torch.from_numpy(x * np.float32(1 + 1e-6))).numpy() - got)
    want = np.asarray(jax.jit(lambda v, xx: _jax_model().apply(v, xx, False))(
        ti.rfnet_variables_from_state_dict(model.state_dict()), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 3, 1, 224, 224) and np.isfinite(got).all()
    err, witness = np.abs(got - want).max(), np.abs(witness).max()
    print("RFNet forward against JAX:", err, "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)


def test_train_step_matches_jax(monkeypatch):
    """One step at B=1, 64x64, f32 (no dropout, no BatchNorm: training mode
    is eval mode), against JAX's ``value_and_grad`` of the same loss: the
    loss within 1e-5 and the gradients to N1's bounds
    (``torch_zoo_step.hold_step``), every tensor within TENSOR_BOUND of its
    norm. Every conv feeds an InstanceNorm, so the weight gradients sum
    terms that nearly cancel, and the summation order shows: the worst
    tensor, a 128^3 conv's weight, is 1.4% of its norm from JAX, against a
    witness (the port under a 1e-6 change of the input) of 0.19%. Measured
    once against the port's step in float64: PyTorch's oneDNN conv3d weight
    gradient is 0.85% from it at 128^3 (PyTorch's own CPU conv 0.015%, JAX
    0.01%); the float64 step needs 16 GB here (the CPU conv's unfolded
    input), so the card holds RFNet's step against float64 instead
    (``chip_smoke.py`` phase 13 (d)). The conv biases' gradients are 0 but
    for rounding. The region map generators' outputs are detached: their
    parameters get no gradient in the port, exactly zero in JAX."""
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard
    from corrifnet_tpu_torch.train import masked_loss_and_jaccard

    model = create_model("RFNet", seed=0)
    x, masks, valid = _inputs(131)
    jm = _jax_model()

    def loss_fn(params, xx):
        out = jm.apply({"params": params}, xx, True)
        return _masked_loss_and_jaccard(out.astype(jnp.float32), jnp.asarray(masks),
                                        jnp.asarray(valid))[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
        ti.rfnet_variables_from_state_dict(model.state_dict())["params"], jnp.asarray(x))

    def port_step(xx):
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(torch.from_numpy(xx)).float()
        loss, _, _ = masked_loss_and_jaccard(out, torch.from_numpy(masks),
                                             torch.from_numpy(valid))
        loss.backward()
        return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                             if p.grad is not None}

    loss, got = port_step(x)
    _, moved = port_step(x * np.float32(1 + 1e-6))
    want = {k: v.numpy() for k, v in rfnet_named_gradients(
        jax.tree.map(np.asarray, grads_j)).items()}
    detached = {n for n, _ in model.named_parameters() if ".prm_generator" in n}
    assert len(detached) == 4 * 10
    assert sorted(got) == sorted(set(want) - detached)
    assert all(not np.any(want[n]) for n in detached)
    assert abs(loss - float(loss_j)) <= 1e-5, (loss, float(loss_j))
    # every conv bias feeds an InstanceNorm, which takes its mean out
    zero = {n for n in got if n.endswith(".conv.bias")}
    assert len(zero) == 3 * 12 + 4 * 6 + 9
    hold_step("RFNet", model, port_step, x, got, {n: want[n] for n in got}, moved,
              monkeypatch, zero, tensor_bound=TENSOR_BOUND)


def test_state_dict_round_trip_is_exact():
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit: the port's
    state_dict converts into a tree of exactly the JAX init tree's structure
    (148 leaves, the encoders stacked; 1,635,369 parameters in the port's 196
    tensors), and back."""
    model = create_model("RFNet", seed=1)
    assert sum(p.numel() for p in model.parameters()) == RFNET_PARAMS
    sd = model.state_dict()
    shapes = jax.eval_shape(lambda: _jax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 64, 64), jnp.float32)))["params"]
    want_shapes = {k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    variables = ti.rfnet_variables_from_state_dict(sd)
    got_shapes = {k: v.shape for k, v in flatten_variables(variables["params"]).items()}
    assert got_shapes == want_shapes and len(want_shapes) == JAX_LEAVES
    assert len(sd) == RFNET_TENSORS
    assert sum(math.prod(s) for s in want_shapes.values()) == RFNET_PARAMS
    back = rfnet_state_dict_from_variables(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())

    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32), shapes)
    model.load_state_dict(rfnet_state_dict_from_variables({"params": tree}), strict=True)
    want, got = flatten_variables(tree), flatten_variables(
        ti.rfnet_variables_from_state_dict(model.state_dict())["params"])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_state_without_adam_moments_resumes():
    """After a step the generators' parameters have no Adam state (no
    gradient), as the JAX package's have zero moments and move by 0. The
    checkpointed ``TrainState`` loads into a fresh one, and the two take the
    same second step bit for bit, the generators unmoved."""
    x, masks, valid = (torch.from_numpy(a) for a in _inputs(5))
    model = create_model("RFNet", seed=3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = init_state(model, "Adam")
    step = make_train_step(state)
    step(x, masks, valid, 1e-3)
    names = [n for n, _ in model.named_parameters()]
    buffer = io.BytesIO()  # as Checkpointer.save_state writes it
    torch.save(state.state_dict(), buffer)
    buffer.seek(0)
    held = torch.load(buffer, weights_only=True)
    with_moments = {names[i] for i in held["optimizer"]["state"]}
    assert with_moments == {n for n in names if ".prm_generator" not in n}

    twin = init_state(create_model("RFNet", seed=9), "Adam").load_state_dict(held)
    assert twin.step == 1
    for s in (state, twin):
        make_train_step(s)(x, masks, valid, 1e-3)
    for (n, p), q in zip(model.named_parameters(), twin.model.parameters()):
        assert torch.equal(p, q), n
        if ".prm_generator" in n:
            assert torch.equal(p, before[n]), n


def test_jax_rfnet_has_no_4_axis_kernel():
    """``transfertype='notr'`` re-initializes 4-axis kernels only; RFNet's
    are all 3-D convs (5 axes in JAX), so it re-initializes none."""
    from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme

    shapes = jax.eval_shape(lambda: _jax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 64, 64), jnp.float32)))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert not [p for p, s in flat if len(s.shape) == 4]
    assert apply_reference_init_scheme(create_model("RFNet"), "kaiming_normal_",
                                       torch.Generator().manual_seed(0)) == []
