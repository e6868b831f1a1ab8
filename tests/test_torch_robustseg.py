"""The port's RobustMseg against the JAX package, on the CPU in f32.

The JAX side gets the port's weights through
``corrifnet_tpu.models.torch_import.robustseg_variables_from_state_dict``;
its abstract shapes come from ``jax.eval_shape``. At B=1 on a 64x64 input:

* the whole forward, with a modality dropped (an all-zero input) and without;
* one training step with the content encoders' Dropout2d on, the same
  (sample, channel) masks injected on both sides: the loss and the gradients
  to N1's bounds;
* the style encoders and reconstruction decoders, which the port keeps but
  does not compute: JAX's output does not move when their parameters do,
  their JAX gradients are zero and Adam leaves them as they are on both sides;
* the ``state_dict`` both ways through the JAX converter, bit for bit, with
  the leaf and parameter counts;
* ``transfertype='notr'``: the port re-initializes the 54 tensors that the
  JAX package does, not the per-modality encoder kernels it stacks to 5
  axes (its 18 leaves), nothing of the other ported models, and each scheme
  draws with its standard deviation.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import (
    create_model,
    robustseg_named_gradients,
    robustseg_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
from corrifnet_tpu_torch.train import init_state, make_train_step, masked_loss_and_jaccard
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_step import hold_step

ROBUSTSEG_PARAMS = 8_403_152  # the JAX init tree's (jax.eval_shape)
ROBUSTSEG_TENSORS = 132  # the port's state_dict
JAX_LEAVES = 96  # the style and content encoders' 3 x (6 + 12) kernels stacked
MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
UNCOMPUTED = ("style_enc_list.", "recon_decoders.")


def _jax_model():
    from corrifnet_tpu.models.robustseg import RobustMseg

    return RobustMseg(dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_shapes():
    return jax.eval_shape(lambda: _jax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 64, 64), jnp.float32)))["params"]


def _inputs(seed, drop=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, 3, 3, 64, 64)).astype(np.float32)
    if drop is not None:
        x[:, drop] = 0.0
    masks = (rng.random((1, 3, 1, 64, 64)) > 0.7).astype(np.float32)
    return x, masks, np.ones(1, np.float32)


@pytest.mark.parametrize("drop", [None, 1])
def test_whole_model_matches_jax(drop):
    """B=1, 64x64, f32, eval mode: the probabilities within MODEL_ATOL, or
    twice the port's own change under a 1e-6 change of the input. With the
    NIR modality all zero its content is dropped. Measured: 1.8e-6."""
    model = create_model("RobustMseg", seed=0)
    x, _, _ = _inputs(11, drop)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        witness = np.abs(model(torch.from_numpy(x * np.float32(1 + 1e-6))).numpy()
                         - got).max()
    want = np.asarray(jax.jit(lambda v, xx: _jax_model().apply(v, xx, False))(
        ti.robustseg_variables_from_state_dict(model.state_dict()), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 3, 1, 64, 64) and np.isfinite(got).all()
    err = np.abs(got - want).max()
    print("RobustMseg forward against JAX:", err, "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)


class _InjectedMasks:
    """A ``DropoutRng`` stand-in that hands each Dropout2d the keep mask of
    its level (keyed by its channel count), the same for every modality."""

    def __init__(self, masks):
        self.masks = masks  # {channels: (B, C) bool}

    def keep(self, x, rate):
        assert rate == 0.3 and x.shape[2:] == (1, 1)
        return torch.from_numpy(self.masks[x.shape[1]])[:, :, None, None]


def _level_masks(batch, seed):
    rng = np.random.default_rng(seed)
    return {c: rng.random((batch, c)) >= 0.3 for c in (16, 32, 64, 128)}


def test_train_step_with_injected_dropout_matches_jax(monkeypatch):
    """One training-mode step at B=1, 64x64, f32, the content encoders'
    Dropout2d on with the same masks on both sides (JAX's
    ``jax.random.bernoulli`` answered from the table, once per level: inside
    ``nn.vmap`` the constant mask is every modality's): the loss within 1e-5
    and the gradients to ``torch_zoo_step.hold_step``'s bounds. No conv has a
    bias. The style encoders' and reconstruction decoders' parameters get no
    gradient in the port and exactly zero in JAX. Measured: loss 1e-8,
    cosine 0.99999."""
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard

    table = _level_masks(1, 7)
    model = create_model("RobustMseg", seed=0)
    model.set_dropout_rng(_InjectedMasks(table))
    x, masks, valid = _inputs(131)

    def bernoulli(key, p, shape):
        assert abs(p - 0.7) < 1e-12 and shape[1:3] == [1, 1], (p, shape)
        return jnp.asarray(table[shape[3]][:, None, None, :])

    jm = _jax_model()

    def loss_fn(params, xx):
        out = jm.apply({"params": params}, xx, True, rngs={"dropout": jax.random.PRNGKey(0)})
        return _masked_loss_and_jaccard(out.astype(jnp.float32), jnp.asarray(masks),
                                        jnp.asarray(valid))[0]

    with monkeypatch.context() as patch:
        patch.setattr(jax.random, "bernoulli", bernoulli)
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
            ti.robustseg_variables_from_state_dict(model.state_dict())["params"],
            jnp.asarray(x))

    def port_step(xx):
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(torch.from_numpy(xx)).float()
        loss, _, _ = masked_loss_and_jaccard(out, torch.from_numpy(masks).to(out.dtype),
                                             torch.from_numpy(valid).to(out.dtype))
        loss.backward()
        return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                             if p.grad is not None}

    loss, got = port_step(x)
    _, moved = port_step(x * np.float32(1 + 1e-6))
    want = {k: v.numpy() for k, v in robustseg_named_gradients(
        jax.tree.map(np.asarray, grads_j)).items()}
    uncomputed = {n for n in want if n.startswith(UNCOMPUTED)}
    assert sorted(got) == sorted(set(want) - uncomputed)
    assert all(not np.any(want[n]) for n in uncomputed)
    assert abs(loss - float(loss_j)) <= 1e-5, (loss, float(loss_j))
    hold_step("RobustMseg", model, port_step, x, got, {n: want[n] for n in got}, moved,
              monkeypatch)


def test_uncomputed_branch_moves_nothing(jax_shapes):
    """The style encoders and reconstruction decoders: new random values for
    their parameters leave JAX's jitted output as it was, and
    one Adam step (optax's ``scale_by_adam``, the JAX package's) on their
    zero gradients leaves them as they were; the port's Adam, which sees no
    gradient for them, leaves them too."""
    model = create_model("RobustMseg", seed=2)
    x, masks, valid = _inputs(3)
    params = ti.robustseg_variables_from_state_dict(model.state_dict())["params"]
    jm = _jax_model()
    fwd = jax.jit(lambda p, xx: jm.apply({"params": p}, xx, False))
    rng = np.random.default_rng(4)
    moved = dict(params)
    moved["style_enc"] = jax.tree.map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32),
                                      params["style_enc"])
    for i in range(3):
        moved[f"recon{i}"] = jax.tree.map(
            lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params[f"recon{i}"])
    assert np.array_equal(np.asarray(fwd(params, x)), np.asarray(fwd(moved, x)))

    grads = jax.tree.map(np.zeros_like, params)
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    updates, _ = adam.update(grads, adam.init(params), params)
    assert all(not np.any(np.asarray(u)) for u in jax.tree.leaves(updates))

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.set_dropout_rng(_InjectedMasks(_level_masks(1, 5)))
    make_train_step(init_state(model, "Adam"))(
        *(torch.from_numpy(a) for a in (x, masks, valid)), 1e-3)
    for n, p in model.named_parameters():
        if n.startswith(UNCOMPUTED):
            assert torch.equal(p, before[n]), n


def test_state_dict_round_trip_is_exact(jax_shapes):
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit: the port's
    state_dict converts into a tree of exactly the JAX init tree's structure
    (96 leaves, the per-modality encoders stacked; 8,403,152 parameters in
    the port's 132 tensors), and back."""
    model = create_model("RobustMseg", seed=1)
    assert sum(p.numel() for p in model.parameters()) == ROBUSTSEG_PARAMS
    sd = model.state_dict()
    want_shapes = {k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jax_shapes)).items()}
    variables = ti.robustseg_variables_from_state_dict(sd)
    got_shapes = {k: v.shape for k, v in flatten_variables(variables["params"]).items()}
    assert got_shapes == want_shapes and len(want_shapes) == JAX_LEAVES
    assert len(sd) == ROBUSTSEG_TENSORS
    assert sum(math.prod(s) for s in want_shapes.values()) == ROBUSTSEG_PARAMS
    back = robustseg_state_dict_from_variables(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())

    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32), jax_shapes)
    model.load_state_dict(robustseg_state_dict_from_variables({"params": tree}), strict=True)
    want, got = flatten_variables(tree), flatten_variables(
        ti.robustseg_variables_from_state_dict(model.state_dict())["params"])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _jax_reinitialized(jax_shapes):
    """The port names of the tensors that the JAX package's ``notr``
    re-initializes: its 4-axis ``kernel`` leaves, marked and converted."""
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: np.full(s.shape, float(path[-1].key == "kernel" and len(s.shape) == 4),
                                np.float32), jax_shapes)
    sd = robustseg_state_dict_from_variables({"params": tree})
    return {n for n, v in sd.items() if v.any()}


# scheme: (normal, the std of a (out, in, kh, kw) weight from its fans)
SCHEMES = {"xavier_uniform_": (False, lambda fi, fo: math.sqrt(2.0 / (fi + fo))),
           "xavier_normal_": (True, lambda fi, fo: math.sqrt(2.0 / (fi + fo))),
           "kaiming_uniform_": (False, lambda fi, fo: math.sqrt(2.0 / fi)),
           "kaiming_normal_": (True, lambda fi, fo: math.sqrt(2.0 / fi))}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_notr_reinitializes_what_jax_does(scheme, jax_shapes):
    """``apply_reference_init_scheme`` re-initializes exactly the 54 kernels
    that the JAX package's does (content_attn 4, content_share 4, recon 36,
    seg_decoder 10), leaves the per-modality encoders' kernels (JAX's 18
    stacked leaves, content 12 and style 6: the port's 54 tensors) and
    everything else as built, and draws with the scheme's
    standard deviation: the mean of (w / std)^2 over the 54 tensors' 3.8
    million entries is 1 within five standard errors (its variance per
    entry: 2 for a normal draw, 4/5 for a uniform one)."""
    model = create_model("RobustMseg", seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = apply_reference_init_scheme(model, scheme, torch.Generator().manual_seed(3))
    want = _jax_reinitialized(jax_shapes)
    assert set(names) == want and len(names) == 54
    assert sorted({n.split(".")[0] for n in names}) == [
        "content_attn", "content_share", "recon_decoders", "seg_decoder"]
    untouched_encoders = [n for n in before
                          if n.startswith(("style_enc_list.", "content_enc_list."))
                          and before[n].dim() == 4]
    assert len(untouched_encoders) == 3 * 18
    params = dict(model.named_parameters())
    for n in before:
        assert torch.equal(params[n], before[n]) == (n not in want), n
    normal, std = SCHEMES[scheme]
    sq, count = 0.0, 0
    for n in names:
        w = params[n].detach().double()
        fi, fo = w.shape[1] * w[0, 0].numel(), w.shape[0] * w[0, 0].numel()
        sq += float(((w / std(fi, fo)) ** 2).sum())
        count += w.numel()
    mean = sq / count
    assert abs(mean - 1.0) <= 5 * math.sqrt((2.0 if normal else 0.8) / count), (mean, count)


@pytest.mark.parametrize("name", ["MMVit4", "MMVit2", "mmformer", "RFNet"])
def test_notr_leaves_the_other_models(name):
    """No other ported model has a 2-D conv: ``notr`` changes none of their
    tensors."""
    model = create_model(name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert apply_reference_init_scheme(model, "xavier_normal_",
                                       torch.Generator().manual_seed(0)) == []
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
