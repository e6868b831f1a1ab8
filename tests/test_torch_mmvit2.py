"""The port's MMVit2 and mmformer against the JAX package, on the CPU in f32.

Inputs come from numpy seeds; the JAX side runs with ``use_pallas=False`` (its
XLA paths), as its own MMVit2 tests do, with the port's weights converted by
``corrifnet_tpu.models.torch_import.mmvit2_variables_from_state_dict``:

* one modality's ``ConvEncoder`` at 64x64, all six outputs;
* ``DecoderFuse(use_reduce=False)`` at MMVit2's skip depths (3/2/1/1), in
  its three forms (the fused standard chain, the lean cascade, the plain
  chain), output and gradients;
* the nearest tap tables at skip depths 1 and 2;
* the ``state_dict`` both ways through the JAX converter, bit for bit, with
  the parameter counts;
* the whole forward of both models at B=1 on a 64x64 input (the decoder's
  grids are fixed, so every path of the 224x224 model runs), and one
  training step;
* the JAX-side facts the port relies on: no 4-axis ``kernel`` leaf (so
  ``transfertype='notr'`` re-initializes nothing), and the JAX build ignores
  ``decoder_lean`` and ``pallas_fused_blocks`` for these models.

The port's K3 computes InstanceNorm's variance in two passes, the JAX
package's XLA InstanceNorm in one (``corrifnet_tpu/nn/norm.py:127-135``):
the same function up to f32 reassociation. The module tests that hold a
tight bound patch the single-pass epilogue into K3's call site (as the
decoder tests do); the whole-model tests run the port as it is.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import (
    create_model,
    jax_import,
    mmvit2_named_gradients,
    mmvit2_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.decoder import DecoderFuse
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.models.mmvit2 import ConvEncoder
from corrifnet_tpu_torch.nn import conv as tconv
from corrifnet_tpu_torch.nn import depthfuse, resize_nearest
from corrifnet_tpu_torch.nn.leandec import relu_in_stats
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# the JAX trees' parameter count (jax.eval_shape of init): both classes keep
# the qkv leaves; the port's mmformer, in the reference layout, has none
MMVIT2_PARAMS = 15_913_915
MMFORMER_PARAMS = MMVIT2_PARAMS - 3 * (512 * 1536 + 1536)  # 13,550,011
MODELS = {"MMVit2": False, "mmformer": True}  # name: the converter's mmformer flag
# ROADMAP Queue 3: the f32 whole-model forward bound
MODEL_ATOL = 5e-5
ENCODER_REL = 5e-5  # the encoder's outputs, of each one's largest entry


def _normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0.0, scale, shape).astype(np.float32)


def _cl(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _single_pass_epilogue(y):
    """K3's function with the JAX package's XLA statistics (single-pass),
    on channels-last ``y``."""
    ys, a, b = relu_in_stats(y.permute(0, 4, 1, 2, 3))
    return (ys * a + b).permute(0, 2, 3, 4, 1)


@pytest.fixture
def single_pass(monkeypatch):
    monkeypatch.setattr(tconv, "relu_instancenorm", _single_pass_epilogue)


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return module


def _model(name, **kwargs):
    """The port's model from seed 0 with random positional embeddings (zero
    at initialization: random ones reach the paths that add them)."""
    model = create_model(name, dtype=torch.float32, device="cpu", seed=0, **kwargs)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("_pos"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    return model


def _jax_model(name, **kwargs):
    from corrifnet_tpu.models.mmvit2 import MMFormer, MMVit2

    cls = MMFormer if MODELS[name] else MMVit2
    return cls(dtype=jnp.float32, use_pallas=False, **kwargs)


def _variables(model, name):
    return ti.mmvit2_variables_from_state_dict(model.state_dict(), mmformer=MODELS[name])


# ---------------------------------------------------------------- encoder


@pytest.mark.parametrize("epilogue", ["single_pass", "kernel"])
def test_conv_encoder_matches_jax(epilogue, monkeypatch):
    """One modality's encoder at 64x64, B=2: the five levels and x6, each
    within ENCODER_REL of its largest entry, with the single-pass epilogue
    on both sides and with K3's two-pass statistics (the port as it runs).
    Rounding grows through the 14 InstanceNorms in sequence, the deepest
    normalizing 16 values a channel: measured 8e-7 of the largest entry at
    x1 to 1.2e-5 (single-pass) and 1.6e-5 (two-pass) at x5."""
    from corrifnet_tpu.models.mmvit2 import ConvEncoder as JaxEncoder

    if epilogue == "single_pass":
        monkeypatch.setattr(tconv, "relu_instancenorm", _single_pass_epilogue)
    enc = _seeded(ConvEncoder(), 3)
    x = _normal((2, 1, 3, 64, 64), 4)
    with torch.no_grad():
        got = [t.numpy() for t in enc(torch.from_numpy(x))]
    sd = {f"enc.{k}": v for k, v in enc.state_dict().items()}
    params = ti._mm2_encoder(sd, "enc")
    want = JaxEncoder(dtype=jnp.float32).apply({"params": params}, jnp.asarray(_cl(x)), False)
    shapes = [(2, 8, 3, 64, 64), (2, 16, 2, 32, 32), (2, 32, 1, 16, 16),
              (2, 64, 1, 8, 8), (2, 64, 1, 4, 4), (2, 64, 8, 8, 8)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == shapes[i]
        assert _rel(_cl(g), w) <= ENCODER_REL, (i, _rel(_cl(g), w))


# ---------------------------------------------------------------- decoder

# MMVit2's skips at 1/4 of their sides (the decoder's grids are fixed)
_SKIPS = [(1, 24, 3, 56, 56), (1, 48, 2, 28, 28), (1, 96, 1, 14, 14),
          (1, 192, 1, 7, 7), (1, 192, 8, 8, 8)]
_FORMS = {"fused": dict(lean=False), "lean": dict(lean=True),
          "plain": dict(fuse_depth=False)}


@pytest.mark.parametrize("form", list(_FORMS))
def test_decoder_without_reduce_matches_jax(form, single_pass):
    """``DecoderFuse(use_reduce=False)`` on skips at depths 3/2/1/1 against
    JAX's in the same form, the single-pass epilogue on both sides; no
    ``RFM5_reduce``, and ``d4_c1`` takes 192 channels. Bounds, as
    ``tests/test_torch_decoder.py`` holds MMVit4's decoder against JAX's:
    the output within 5e-5; the gradients of mean(out^2) to the whole-step
    test's bounds (the cosine of the whole gradient >= 0.97, every tensor
    within 0.4 of its norm, the head's bias within 2e-4 of its largest
    entry), since a conv bias before ReLU+InstanceNorm sums millions of
    cancelling terms. Measured: output 1.4e-5; cosine 0.999995 or above; the
    worst tensor 3.0e-3 (fused, lean) and 1.1e-2 (plain) of its norm, conv
    biases both; the head 1e-6."""
    from corrifnet_tpu.models.decoder import DecoderFuse as JaxDecoder

    xs = [_normal(s, 40 + i) for i, s in enumerate(_SKIPS)]
    dec = _seeded(DecoderFuse(use_reduce=False, **_FORMS[form]), 9)
    assert not any("RFM5_reduce" in k for k in dec.state_dict())
    assert dec.d4_c1.conv.weight.shape[1] == 192
    out = dec(*map(torch.from_numpy, xs))
    names = [n for n, _ in dec.named_parameters()]
    grads = torch.autograd.grad((out * out).mean(), list(dec.parameters()))
    got = {f"decoder_fuse.{n}": g.numpy() for n, g in zip(names, grads)}

    jm = JaxDecoder(depth_mode="full", use_reduce=False, **_FORMS[form])
    sd = {f"decoder_fuse.{k}": v for k, v in dec.state_dict().items()}
    params = ti._decoder(sd, use_reduce=False)
    jxs = [jnp.asarray(_cl(x)) for x in xs]

    def loss(p):
        o = jm.apply({"params": p}, *jxs, True)
        return (o * o).mean(), o

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    named = {}
    jax_import._decoder(named, jax.tree.map(np.asarray, jgrads))
    want_g = {k: v.numpy() for k, v in named.items()}
    assert out.shape == want.shape == (1, 3, 1, 224, 224)
    assert sorted(got) == sorted(want_g)
    err = np.abs(out.detach().numpy() - np.asarray(want)).max()
    cosine, worst = _agreement(got, want_g)
    head = _rel(got["decoder_fuse.final_conv.bias"], want_g["decoder_fuse.final_conv.bias"])
    print(form, "decoder against JAX:", err, cosine, worst, head)
    assert err <= MODEL_ATOL
    assert cosine >= 0.97 and worst[0] <= 0.4 and head <= 2e-4, (cosine, worst, head)


@pytest.mark.parametrize("src", [1, 2])
def test_nearest_tap_tables_at_mmvit2_skip_depths(src):
    """The nearest tables at MMVit2's skip depths 1 and 2 equal JAX's
    element for element, and pick the rows the port's nearest resize picks."""
    from corrifnet_tpu.nn.depthfuse import tap_expand_table as jax_table

    x = torch.arange(float(src)).view(1, 1, src, 1, 1)
    for dst in (16, 32, 64, 128):
        for pad_mode in ("replicate", "zeros"):
            got = depthfuse.tap_expand_table("nearest", src, dst, pad_mode)
            assert got.shape == (dst, 3, src)
            np.testing.assert_array_equal(got.astype(np.float32),
                                          jax_table("nearest", src, dst, pad_mode))
        rows = resize_nearest(x, (dst, 1, 1)).flatten().long().numpy()
        table = depthfuse.tap_expand_table("nearest", src, dst)[:, 1, :]
        np.testing.assert_array_equal(table.argmax(1), rows)


# ---------------------------------------------------------------- weights


def _jax_shapes(name):
    return jax.eval_shape(
        lambda r, xx: _jax_model(name).init({"params": r}, xx, False),
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 64, 64), jnp.float32))


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_round_trip_is_exact(name):
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit: the port's
    state_dict converts into a tree of exactly the JAX init tree's structure
    (117 leaves, 15,913,915 parameters for both classes), and back. The
    mmformer tree's qkv leaves are zero (the converter fills them; the port
    has no qkv)."""
    mmformer = MODELS[name]
    model = create_model(name, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == (MMFORMER_PARAMS if mmformer else MMVIT2_PARAMS)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    sd = model.state_dict()
    variables = ti.mmvit2_variables_from_state_dict(sd, mmformer=mmformer)
    want_shapes = {k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), _jax_shapes(name)["params"])
    ).items()}
    got_shapes = {k: v.shape for k, v in flatten_variables(variables["params"]).items()}
    assert got_shapes == want_shapes and len(want_shapes) == 117
    assert sum(math.prod(s) for s in want_shapes.values()) == MMVIT2_PARAMS
    back = mmvit2_state_dict_from_variables(variables, mmformer=mmformer)
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        assert back[key].shape == value.shape and torch.equal(back[key], value), key

    # the other way: a JAX tree of random numbers (mmformer's qkv zero)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32),
                        _jax_shapes(name)["params"])
    if mmformer:
        tree["modality_stream"]["qkv"] = jax.tree.map(np.zeros_like,
                                                      tree["modality_stream"]["qkv"])
    model.load_state_dict(mmvit2_state_dict_from_variables({"params": tree}, mmformer),
                          strict=True)
    again = ti.mmvit2_variables_from_state_dict(model.state_dict(), mmformer=mmformer)
    want, got = flatten_variables(tree), flatten_variables(again["params"])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_mmformer_conversion_refuses_live_qkv():
    """An MMVit2 tree (its qkv leaves non-zero) does not convert as mmformer:
    the converter would drop weights."""
    variables = ti.mmvit2_variables_from_state_dict(create_model("MMVit2").state_dict())
    with pytest.raises(ValueError, match="qkv"):
        mmvit2_state_dict_from_variables(variables, mmformer=True)


def test_jax_facts_notr_and_ignored_options():
    """(1) Neither package has a parameter with a 4-axis kernel, so
    ``transfertype='notr'`` (which re-initializes 4-axis conv kernels,
    ``corrifnet_tpu/nn/init.py:107-139``) changes nothing, and the port's
    silent skip of it is exact. (2) The JAX entry point builds MMVit2 and
    mmformer with ``dtype``, ``use_pallas`` and ``depth_mode`` only: its
    ``decoder_lean`` and ``pallas_fused_blocks`` have no effect there, and
    the port prints a line naming them and builds the same model."""
    from corrifnet_tpu.config import ExperimentConfig as JaxConfig
    from corrifnet_tpu.run.main import _build_model

    for name in MODELS:
        flat = flatten_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                              _jax_shapes(name)["params"]))
        assert not [k for k, v in flat.items() if k.endswith("kernel") and v.ndim == 4]
        assert not [n for n, p in create_model(name).named_parameters() if p.dim() == 4]
        plain, _ = _build_model(JaxConfig(modeltype=name))
        levers, _ = _build_model(JaxConfig(modeltype=name, decoder_lean=False,
                                           pallas_fused_blocks=True))
        assert levers == plain
        assert not hasattr(levers, "decoder_lean")
        assert not hasattr(levers, "pallas_fused_blocks")
        a = create_model(name, seed=4)
        b = create_model(name, seed=4, decoder_lean=False, pallas_fused_blocks=True)
        assert b.decoder_fuse.lean is None and b.decoder_fuse._uses_lean(4)
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())


# ---------------------------------------------------------------- whole model


def _witness_forward(model, x):
    """max |output change| of the port under a 1e-6 relative change of the
    input: f32 rounding, as amplified by this network at this input."""
    with torch.no_grad():
        return (model(torch.from_numpy(x)) - model(torch.from_numpy(x * np.float32(1 + 1e-6)))
                ).abs().max().item()


@pytest.mark.parametrize("name", list(MODELS))
def test_whole_model_matches_jax(name):
    """Both models at B=1 on a 64x64 input in f32, the port as it runs (K3's
    two-pass statistics) against JAX's ``apply``: within MODEL_ATOL, or
    twice the witness where the network's own amplification of f32 rounding
    is larger. MMVit2's correlation softmaxes saturate at random
    initialization (scores q k / sqrt(3) up to about 120): there a 1e-6
    change of the input moves the port's output by about 6e-5 (mmformer's by
    about 2.5e-5), so MODEL_ATOL is below what f32 can show (the JAX
    package's own reference test of MMVit2 allows 1.5e-3). Measured: MMVit2
    8.7e-5 (6.1e-5 with the single-pass epilogue), mmformer 2.1e-5."""
    model = _model(name)
    x = _normal((1, 3, 3, 64, 64), 11)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jm = _jax_model(name)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False))(
        _variables(model, name), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 3, 1, 224, 224)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    witness = _witness_forward(model, x)
    print(name, "forward against JAX:", err, "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)


def _agreement(got, want):
    """(cosine over all tensors, (worst per-tensor ||got - want|| / ||want||,
    its name))."""
    dot = sum(float((got[n] * want[n]).sum()) for n in want)
    norms = math.sqrt(sum(float((got[n] ** 2).sum()) for n in want)
                      * sum(float((want[n] ** 2).sum()) for n in want))
    worst = max((float(np.linalg.norm(got[n] - want[n])
                       / max(np.linalg.norm(want[n]), 1e-30)), n) for n in want)
    return dot / norms, worst


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(name):
    """One training-mode step at B=1, 64x64, f32, dropout 0 (InstanceNorm
    only, so train mode differs from eval by dropout alone), the port as it
    runs against JAX's ``value_and_grad`` of the same loss. Bounds: the
    loss within 1e-5; the gradients to N1's f32 bounds (ROADMAP Queue 3: the
    cosine of the whole gradient >= 0.97, every tensor within 0.4 of its
    norm, the head's bias within 2e-4 of its largest entry), and every
    tensor within twice the worst that the port shows against itself under
    a 1e-6 change of the input (the witness). Measured: loss 6e-8, cosine
    0.99999 (MMVit2) and 0.99997 (mmformer), worst tensor 0.008 and 0.011
    of its norm against a witness of 0.042 and 0.025."""
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard
    from corrifnet_tpu_torch.train import masked_loss_and_jaccard

    model = _model(name, transformer_dropout=0.0)
    rng = np.random.default_rng(131)
    x = rng.normal(0, 1, (1, 3, 3, 64, 64)).astype(np.float32)
    masks = (rng.random((1, 3, 1, 224, 224)) > 0.7).astype(np.float32)
    valid = np.ones(1, np.float32)
    jm = _jax_model(name, transformer_dropout=0.0)

    def loss_fn(params, xx):
        out = jm.apply({"params": params}, xx, True, rngs={"dropout": jax.random.PRNGKey(0)})
        return _masked_loss_and_jaccard(out.astype(jnp.float32), jnp.asarray(masks),
                                        jnp.asarray(valid))[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
        _variables(model, name)["params"], jnp.asarray(x))

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
    want = {k: v.numpy() for k, v in mmvit2_named_gradients(
        jax.tree.map(np.asarray, grads_j), mmformer=MODELS[name]).items()}
    assert sorted(got) == sorted(want) == sorted(n for n, _ in model.named_parameters())
    cosine, worst = _agreement(got, want)
    _, witness = _agreement(moved, got)
    head = "decoder_fuse.final_conv.bias"
    head_err = _rel(got[head], want[head])
    print(name, "train step against JAX:", loss, float(loss_j), cosine, worst, witness,
          head_err)
    assert abs(loss - float(loss_j)) <= 1e-5
    assert cosine >= 0.97 and worst[0] <= 0.4, (cosine, worst)
    assert worst[0] <= 2 * witness[0], (worst, witness)
    assert head_err <= 2e-4, head_err
