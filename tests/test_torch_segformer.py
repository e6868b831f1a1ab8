"""The port's Segformer against the JAX package, on the CPU in f32.

The JAX side gets the port's weights through
``corrifnet_tpu.models.torch_import.segformer_variables_from_state_dict``;
its abstract shapes come from ``jax.eval_shape``. Segformer is on the 4-D
input path: one modality, (B, 3, H, W); its output is (B, 1, *out_size),
``out_size`` (224, 224) by default whatever the input, so the 64x64 cases
give both sides ``out_size=(64, 64)``.

* Primitives: ``ChannelNorm`` (eps outside the sqrt), the efficient
  self-attention at each stage's reduction ratio, the mix feed-forward, the
  overlapping-patch embed from its ``(O, I*k*k, 1, 1)`` weight;
* the whole forward at B=1, 64x64 and at 224x224 (the entry points'
  width), and the debug variant (nearest fusion on the stride-4 grid, the
  split head, raw logits, the three shape prints) with its ``state_dict``;
* one training step at B=2, 64x64: the loss within 1e-5 and the gradients
  to ``torch_zoo_step.hold_step``'s bounds (no BatchNorm, so no gradient is
  0 but for rounding);
* the ``state_dict`` both ways through the JAX converter, bit for bit;
  ``notr`` re-initializes the JAX package's 66 kernels, the patch embeds
  with the JAX kernels' fans; each initializer draws with its deviation.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import segformer as js
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu.nn import Conv as JConv
from corrifnet_tpu_torch.models import (
    create_model,
    segformer_named_gradients,
    segformer_state_dict_from_variables,
)
from corrifnet_tpu_torch.models import segformer as ps
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.nn import Conv
from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
from corrifnet_tpu_torch.testing import zero_gradients
from corrifnet_tpu_torch.train import masked_loss_and_jaccard
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_step import SCHEMES, hold_scheme_std, hold_step, jax_reinitialized

F32 = jnp.float32
SEGFORMER_PARAMS = 7_717_473  # the JAX init tree's (jax.eval_shape)
JAX_PARAM_LEAVES = 140
NOTR_KERNELS = 66  # the JAX tree's 4-axis kernels: every conv
MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
PRIMITIVE_ATOL = 2e-5


def _jax_model(**kw):
    return js.Segformer(dtype=F32, **kw)


def _port_model(seed, **kw):
    return ps.Segformer(**kw).reset_parameters(torch.Generator().manual_seed(seed)).eval()


@pytest.fixture(scope="module")
def jax_shapes():
    return jax.eval_shape(lambda: _jax_model(out_size=(64, 64)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64), F32)))


def _nhwc(t):
    return jnp.asarray(np.moveaxis(t.detach().numpy(), 1, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _convs(module, names):
    sd = module.state_dict()
    return {n: ti._conv2d(sd, key) for n, key in names.items()}


# ------------------------------------------------------------------ primitives


def test_channel_norm_matches_jax():
    """Per pixel over the channels, the biased variance, eps outside the
    sqrt: pixels of small spread (std ~1e-3) show the eps's place."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 32, 5, 6)).astype(np.float32)
    x[:, :, 0] *= 1e-3
    norm = ps.ChannelNorm(32)
    with torch.no_grad():
        norm.g.copy_(torch.from_numpy(rng.normal(1, 0.2, (1, 32, 1, 1)).astype(np.float32)))
        norm.b.copy_(torch.from_numpy(rng.normal(0, 0.2, (1, 32, 1, 1)).astype(np.float32)))
        got = norm(torch.from_numpy(x)).numpy()
    params = ti._channelnorm({"n.g": norm.g, "n.b": norm.b}, "n")
    want = _nchw(js.ChannelNorm(dtype=F32).apply({"params": params}, _nhwc(torch.from_numpy(x))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    eps_inside = (x - x.mean(1, keepdims=True)) / np.sqrt(x.var(1, keepdims=True) + 1e-5)
    assert np.abs(got[:, :, 0] - (eps_inside[:, :, 0] * norm.g.detach().numpy()[:, :, 0]
                                  + norm.b.detach().numpy()[:, :, 0])).max() > 1e-2


@pytest.mark.parametrize("dim,heads,rr,hw", [(32, 1, 8, 16), (64, 2, 4, 8), (160, 5, 2, 4),
                                             (256, 8, 1, 2)])
def test_efficient_self_attention_matches_jax(dim, heads, rr, hw):
    """Each stage's attention (head dim 32, kv by a kernel-r stride-r conv)
    at the grid a 64x64 input gives it."""
    gen = torch.Generator().manual_seed(dim)
    attn = ps.EfficientSelfAttention(dim, heads, rr)
    for m in attn.modules():
        if isinstance(m, Conv):
            m.reset_parameters(gen)
    x = torch.randn((2, dim, hw, hw), generator=gen)
    with torch.no_grad():
        got = attn(x).numpy()
    params = _convs(attn, {n: n for n in ("to_q", "to_kv", "to_out")})
    want = _nchw(js.EfficientSelfAttention(dim, heads, rr, dtype=F32).apply(
        {"params": params}, _nhwc(x)))
    assert got.shape == (2, dim, hw, hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRIMITIVE_ATOL)


def test_mix_feed_forward_matches_jax():
    """1x1, depthwise 3x3, 1x1, exact GELU, 1x1, as JAX orders them."""
    gen = torch.Generator().manual_seed(1)
    ff = ps.MixFeedForward(32, 8)
    for m in ff.modules():
        if isinstance(m, Conv):
            m.reset_parameters(gen)
    x = torch.randn((2, 32, 9, 7), generator=gen)
    with torch.no_grad():
        got = ff(x).numpy()
    params = _convs(ff, {"fc1": "net.0", "dw": "net.1.net.0", "pw": "net.1.net.1",
                         "fc2": "net.3"})
    want = _nchw(js.MixFeedForward(32, 8, dtype=F32).apply({"params": params}, _nhwc(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=PRIMITIVE_ATOL)


@pytest.mark.parametrize("cin,cout,k,s,p", [(3, 32, 7, 4, 3), (32, 64, 3, 2, 1)])
def test_patch_embed_is_unfold_then_pointwise(cin, cout, k, s, p):
    """The embed from its (O, I*k*k, 1, 1) weight equals the reference's
    ``nn.Unfold`` + 1x1 conv, and JAX's (k, k, I, O) conv from the
    converter's kernel."""
    gen = torch.Generator().manual_seed(k)
    embed = ps.OverlapPatchEmbed(cin, cout, k, s, p)
    embed.reset_parameters(gen)
    x = torch.randn((2, cin, 20, 20), generator=gen)
    with torch.no_grad():
        got = embed(x)
        cols = torch.nn.functional.unfold(x, k, stride=s, padding=p)
        side = (20 + 2 * p - k) // s + 1
        ref = torch.nn.functional.conv2d(cols.view(2, -1, side, side), embed.weight,
                                         embed.bias)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    params = {"kernel": ti._np(embed.weight).reshape(cout, -1, k, k).transpose(2, 3, 1, 0),
              "bias": ti._np(embed.bias)}
    want = _nchw(JConv(cout, k, strides=s, padding=p, dtype=F32).apply(
        {"params": params}, _nhwc(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ the model


def _inputs(seed, b=1, hw=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, 3, hw, hw)).astype(np.float32)
    masks = (rng.random((b, 1, hw, hw)) > 0.7).astype(np.float32)
    return x, masks, np.ones(b, np.float32)


@pytest.mark.parametrize("hw", [64, 224])
def test_whole_model_matches_jax(hw):
    """B=1, f32: the probabilities within MODEL_ATOL, or twice the port's
    own change under a 1e-6 change of the input; at 224x224 through
    ``create_model`` with the default ``out_size``, as the entry points
    build it. Measured: 1.2e-7 at 64x64."""
    kw = {"out_size": (64, 64)} if hw == 64 else {}
    model = create_model("Segformer", seed=0) if hw == 224 else _port_model(0, **kw)
    x, _, _ = _inputs(11, hw=hw)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        witness = np.abs(model(torch.from_numpy(x * np.float32(1 + 1e-6))).numpy()
                         - got).max()
    want = np.asarray(jax.jit(lambda v, xx: _jax_model(**kw).apply(v, xx, False))(
        ti.segformer_variables_from_state_dict(model.state_dict()), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 1, hw, hw) and np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"Segformer {hw}x{hw} forward against JAX:", err, "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)


def test_debug_variant_matches_jax(capsys):
    """``debug_variant=True`` (the orphan F32 model): stage s fused by a
    nearest x2**s onto the stride-4 grid, the split ``to_segmentation1/2``
    head, raw logits of (1, 1, 16, 16) for a 64x64 input, within MODEL_ATOL
    of JAX's; its three shape prints, NCHW; its ``state_dict`` holds the
    split head's keys and goes both ways through the JAX converter bit for
    bit."""
    model = _port_model(4, debug_variant=True)
    sd = model.state_dict()
    assert {k for k in sd if "segmentation" in k} == {
        f"to_segmentation{i}.{p}" for i in (1, 2) for p in ("weight", "bias")}
    variables = ti.segformer_variables_from_state_dict(sd)
    back = segformer_state_dict_from_variables(variables, debug_variant=True)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    x, _, _ = _inputs(12)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    printed = capsys.readouterr().out.splitlines()
    assert printed == ["(1, 1024, 16, 16)", "Output Size after Conv1: (1, 256, 16, 16)",
                       "Output Size after Conv2: (1, 1, 16, 16)"]
    want = np.asarray(_jax_model(debug_variant=True).apply(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (1, 1, 16, 16)
    assert got.min() < 0 or got.max() > 1  # logits, no sigmoid
    err = np.abs(got - want).max()
    print("Segformer debug variant against JAX:", err)
    assert err <= MODEL_ATOL, err


def test_train_step_matches_jax(monkeypatch):
    """One training-mode step at B=2, 64x64, f32 (no BatchNorm, no dropout):
    the loss within 1e-5 and the gradients to ``hold_step``'s bounds; every
    parameter has a gradient on both sides, and none is 0 but for
    rounding."""
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard

    model = _port_model(2, out_size=(64, 64))
    x, masks, valid = _inputs(131, b=2)
    variables = ti.segformer_variables_from_state_dict(model.state_dict())
    jm = _jax_model(out_size=(64, 64))

    def loss_fn(params, xx):
        out = jm.apply({"params": params}, xx, True)
        return _masked_loss_and_jaccard(out.astype(F32), jnp.asarray(masks),
                                        jnp.asarray(valid))[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(variables["params"],
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
    want = {k: v.numpy() for k, v in segformer_named_gradients(
        jax.tree.map(np.asarray, grads_j)).items()}
    assert sorted(got) == sorted(want) == sorted(n for n, _ in model.named_parameters())
    assert abs(loss - float(loss_j)) <= 1e-5, (loss, float(loss_j))
    assert zero_gradients(model, batch=2) == []
    hold_step("Segformer", model, port_step, x, got, want, moved, monkeypatch)


def test_state_dict_round_trip_is_exact(jax_shapes):
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit: the port's
    state_dict converts into a tree of exactly the JAX init tree's structure
    (140 parameter leaves, no statistics; 7,717,473 parameters), the embeds
    as the reference's (O, I*k*k, 1, 1) weights, the norms as (1, C, 1, 1),
    and back."""
    model = create_model("Segformer", seed=1)
    assert sum(p.numel() for p in model.parameters()) == SEGFORMER_PARAMS
    sd = model.state_dict()
    assert sd["mit.stages.0.1.weight"].shape == (32, 3 * 49, 1, 1)
    assert sd["mit.stages.3.1.weight"].shape == (256, 160 * 9, 1, 1)
    assert sd["mit.stages.2.2.1.0.norm.g"].shape == (1, 160, 1, 1)
    want_shapes = {k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(jax_shapes))).items()}
    variables = ti.segformer_variables_from_state_dict(sd)
    assert {k: v.shape for k, v in flatten_variables(variables).items()} == want_shapes
    assert len(want_shapes) == len(sd) == JAX_PARAM_LEAVES
    assert sum(math.prod(s) for s in want_shapes.values()) == SEGFORMER_PARAMS
    back = segformer_state_dict_from_variables(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())

    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32),
                        dict(jax_shapes))
    model.load_state_dict(segformer_state_dict_from_variables(tree), strict=True)
    want, got = flatten_variables(tree), flatten_variables(
        ti.segformer_variables_from_state_dict(model.state_dict()))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _embeds(model):
    return [m for m in model.modules() if isinstance(m, ps.OverlapPatchEmbed)]


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_notr_reinitializes_what_jax_does(scheme, jax_shapes):
    """``apply_reference_init_scheme`` re-initializes exactly the 66 kernels
    that the JAX package's does (every conv, the four patch embeds among
    them) and zeroes their biases, leaves the ChannelNorms as built, and
    draws with the scheme's standard deviation, each embed with the fans of
    JAX's (k, k, I, O) kernel: under xavier the fan-out is O*k*k, where the
    stored 1x1 weight's would be O."""
    model = create_model("Segformer", seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = apply_reference_init_scheme(model, scheme, torch.Generator().manual_seed(3))
    want = jax_reinitialized(jax_shapes["params"], segformer_state_dict_from_variables)
    assert len(names) == NOTR_KERNELS and set(names) == {n for n in want
                                                          if n.endswith(".weight")}
    assert {f"mit.stages.{si}.1.weight" for si in range(4)} <= set(names)
    params = dict(model.named_parameters())
    for n in before:
        assert torch.equal(params[n], before[n]) == (n not in want), n
    assert all(not params[n].any() for n in want if n.endswith(".bias"))
    embeds = _embeds(model)
    hold_scheme_std(scheme, [params[n] for n in names
                             if n not in {f"mit.stages.{si}.1.weight" for si in range(4)}])
    hold_scheme_std(scheme, [e.kernel() for e in embeds])
    if scheme.startswith("xavier"):
        # the stored (O, I*k*k, 1, 1) layout's fans would give another std
        with pytest.raises(AssertionError):
            hold_scheme_std(scheme, [e.weight for e in embeds])


def test_initializers_draw_with_their_deviations():
    """The model's own initializers: every conv PyTorch's U(+-1/sqrt(fan_in))
    (the mean of (w / std)^2 over all of them 1 within five standard errors,
    std = bound / sqrt(3)), the embeds' fan-in I*k*k; ChannelNorm ones and
    zeros."""
    model = create_model("Segformer", seed=5)
    sq, count, norms = 0.0, 0, 0
    for module in model.modules():
        if isinstance(module, Conv):
            w = module.weight.detach().double()
            sq += float((w * math.sqrt(3 * w[0].numel())).square().sum())
            count += w.numel()
        elif isinstance(module, ps.ChannelNorm):
            assert bool((module.g == 1).all()) and not module.b.any()
            norms += 1
    assert norms == 16
    assert abs(sq / count - 1) <= 5 * math.sqrt(0.8 / count), (sq / count, count)
