"""The port's ELANet against the JAX package, on the CPU in f32.

ELANet is on the 4-D input path: one modality, (B, 3, H, W); output (B,
1, H, W). The model checks are ``tests/torch_zoo_model.py``'s:

* primitives: ``PReLU`` (per channel and shared, its gradient at 0 split
  evenly as JAX's), CCA at each of its channel counts (the decoder's at
  stride 2), and the ECG blocks in train mode, against the JAX modules;
* the whole forward at B=1 in eval mode, 64x64 and 224x224 (the entry
  points' width), the BatchNorms calibrated (at identity statistics the
  sigmoid saturates);
* one training step at B=2, 64x64, the decoder's dropout (0.5) given the
  same masks on both sides; at B=1 too. The gradients that a BatchNorm makes
  0 but for rounding are the decoder's two conv biases before a BNPReLU
  (``testing.zero_gradients``);
* the ``state_dict`` both ways, bit for bit, 672,556 parameters; ``notr``
  re-initializes the JAX package's 100 kernels (every 2-D conv; CCA's 1-D
  taps are left as built, as in the JAX package).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import elanet as je
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu.nn import PReLU as JPReLU
from corrifnet_tpu_torch.models import elanet as pe
from corrifnet_tpu_torch.models import elanet_state_dict_from_variables
from corrifnet_tpu_torch.nn import PReLU
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_model import (
    F32,
    Zoo,
    check_notr,
    check_round_trip,
    check_train_step,
    check_whole_model,
    nchw,
    nhwc,
)
from torch_zoo_step import SCHEMES

ELANET = Zoo("ELANet", lambda dt: je.ELANet(dtype=dt), ti.elanet_variables_from_state_dict,
             elanet_state_dict_from_variables)
ELANET_PARAMS = 672_556  # the JAX init tree's (jax.eval_shape)
NOTR_KERNELS = 100  # the JAX tree's 4-axis kernels


def _reset(module, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters(gen)
    return module


# ------------------------------------------------------------------ primitives


@pytest.mark.parametrize("channels", [None, 6])
def test_prelu_matches_jax_with_its_gradient(channels):
    """``PReLU`` (one shared slope, or one per channel) against the JAX
    ``PReLU``: the output, and the gradients of the input and the slopes,
    with a tenth of the input exactly 0, where both split the gradient
    evenly between max(x, 0) and w * min(x, 0)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 6, 5, 5), generator=gen)
    x[x.abs() < 0.15] = 0.0
    assert (x == 0).float().mean() > 0.05
    act = PReLU(channels)
    with torch.no_grad():
        act.weight.copy_(torch.rand(act.weight.shape, generator=gen) - 0.5)
    g = torch.randn(x.shape, generator=gen)
    leaf = x.clone().requires_grad_()
    y = act(leaf)
    dx, dw = torch.autograd.grad((y * g).sum(), [leaf, act.weight])
    params = {"alpha": jnp.asarray(act.weight.detach().numpy())}
    jm = JPReLU(channels=channels)

    def f(p, xx):
        return (jm.apply({"params": p}, xx) * nhwc(g)).sum(), jm.apply({"params": p}, xx)

    (_, want), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, nhwc(x))
    np.testing.assert_allclose(y.detach().numpy(), nchw(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), nchw(gx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gp["alpha"]), rtol=1e-5, atol=1e-5)
    # at 0 the input's gradient is g * (1 + w) / 2
    zero = (x == 0).numpy()
    w = act.weight.detach().view(1, -1, 1, 1).expand_as(x).numpy()
    np.testing.assert_allclose(dx.numpy()[zero], (g.numpy() * (1 + w) / 2)[zero], rtol=1e-6)


@pytest.mark.parametrize("cin,cout", [(64, 64), (96, 96), (128, 128), (192, 192), (128, 64)])
def test_cca_matches_jax(cin, cout):
    """CCA at every channel count of the model (ECG_D's 64 and 128, ECG_R's
    96 and 192, the decoder's 128 -> 64 at stride 2): kernel cin / 8 - 1 and
    the padding the counts set, in f32, (B, cout, 1, 1) weights."""
    cca = _reset(pe.CCA(cin, cout), cin + cout)
    x = torch.randn((2, cin, 7, 5), generator=torch.Generator().manual_seed(cin))
    with torch.no_grad():
        got = cca(x).numpy()
    params = ti._ela_cca({f"c.{k}": v for k, v in cca.state_dict().items()}, "c")
    want = nchw(je.CCA(cin, cout, dtype=F32).apply({"params": params}, nhwc(x)))
    assert got.shape == want.shape == (2, cout, 1, 1) and got.dtype == np.float32
    assert cca.conv[0].weight.shape == (1, 1, cin // 8 - 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,cin,cout,dilation", [("D", 32, 64, 2), ("R", 64, 64, 2),
                                                     ("R", 128, 128, 8)])
def test_ecg_block_matches_jax_in_train_mode(kind, cin, cout, dilation):
    """ECG_D and ECG_R in train mode (batch statistics): the output and the
    running statistics after it, converted by JAX's ``_ela_ecg_*``."""
    block = pe.ECG_D(cin, cout, dilation) if kind == "D" else pe.ECG_R(cin, cout, dilation)
    _reset(block, cin + dilation)
    x = torch.randn((2, cin, 12, 12), generator=torch.Generator().manual_seed(cin))
    convert = ti._ela_ecg_d if kind == "D" else ti._ela_ecg_r
    params, stats = convert({f"b.{k}": v.clone() for k, v in block.state_dict().items()}, "b")
    with torch.no_grad():
        got = block.train()(x, torch.float32).numpy()
    jm = (je.ECG_D if kind == "D" else je.ECG_R)(cout, dilation, dtype=F32)
    want, new = jm.apply({"params": params, "batch_stats": stats}, nhwc(x), True,
                         mutable=["batch_stats"])
    np.testing.assert_allclose(got, nchw(want), rtol=0, atol=1e-5 * np.abs(want).max())
    back = convert({f"b.{k}": v for k, v in block.state_dict().items()}, "b")[1]
    for leaf, tree in jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0]:
        got_leaf = back
        for p in leaf:
            got_leaf = got_leaf[p.key]
        np.testing.assert_allclose(got_leaf, tree, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("hw", [64, 224])
def test_whole_model_matches_jax(hw):
    """B=1, f32, eval mode, BatchNorms calibrated: the probabilities within
    5e-5, or twice the port's own change under a 1e-6 change of the input.
    Measured: 3.3e-7 at 64x64."""
    check_whole_model(ELANET, hw)


@pytest.mark.parametrize("b", [2, 1])
def test_train_step_with_injected_dropout_matches_jax(b, monkeypatch):
    """One training-mode step at 64x64, f32, BatchNorm on batch statistics,
    the decoder output's dropout at 0.5 with the same mask on both sides:
    the loss within 1e-5, the gradients to ``hold_step``'s bounds, the
    decoder's two conv biases before a BNPReLU 0 but for rounding on both
    sides (1e-8 of the largest entry in JAX's) at both batch sizes."""
    calls = check_train_step(ELANET, monkeypatch, seed=5, b=b)
    assert calls == [((b, 16, 16, 128), 0.5)]


def test_state_dict_round_trip_is_exact():
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit, under the
    reference's keys."""
    sd = check_round_trip(ELANET, ELANET_PARAMS)
    for key in ("level1_0.conv.weight", "level1_0.act.weight", "level2.1.CA.conv.2.weight",
                "level3.8.F_sur2.conv.weight", "level3_0.reduce.conv.weight",
                "decode.Xd1.1.bias", "decode.Xd2_1.2.bn.running_var", "decode.Xb_1.0.weight",
                "decode.SA.conv.1.conv.weight", "decode.SA.conv.3.bias",
                "decode.bnpre.act.weight", "classifier.0.conv.weight"):
        assert key in sd, key
    assert sd["level1_0.bn.running_var"].shape == (32,)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_notr_reinitializes_what_jax_does(scheme):
    """The 100 kernels of the JAX tree (every 2-D conv), the biases beside
    them zeroed; CCA's taps, the BatchNorms and the PReLU slopes as built."""
    names = check_notr(ELANET, scheme, NOTR_KERNELS)
    assert not any(".CA." in n for n in names)
