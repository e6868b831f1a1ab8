"""The depth-pruned decoder against the JAX package, on the CPU in f32.

* ``resize_linear_depth_prefix`` and ``resize_nearest_depth_prefix`` against
  JAX's, forward and VJP, and the prefix check;
* ``Conv`` with a per-axis ``(before, after)`` padding against JAX's ``Conv``
  with the same padding pairs;
* ``DecoderFuse(depth_mode='pruned')`` against JAX's pruned ``DecoderFuse``
  with the same parameters, forward and every parameter's gradient: with
  ``use_reduce`` (MMVit4's skips, all 3 rows deep) and without (MMVit2's,
  3/2/1/1 rows deep).

Inputs are made from a numpy seed and fed to both sides. The port is NCDHW,
the JAX package channels-last. Each test states its tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu.nn import resize as jax_resize
from corrifnet_tpu_torch.models import jax_import
from corrifnet_tpu_torch.models.decoder import DecoderFuse
from corrifnet_tpu_torch.nn import Conv, conv as tconv
from corrifnet_tpu_torch.nn.leandec import relu_in_stats
from corrifnet_tpu_torch.nn.resize import (
    resize_linear_depth_prefix,
    resize_nearest_depth_prefix,
)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

RESIZE_REL = 1e-6   # 2-tap interpolation sums in f32, in another order
F64_RTOL = 1e-9     # each gradient tensor in float64, relative to its largest entry


def _normal(shape, seed, scale=1.0, shift=0.0):
    return np.random.default_rng(seed).normal(shift, scale, shape).astype(np.float32)


def _cl(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_vjp(fn, x, cot):
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt)
    (g,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [xt])
    return out.detach().numpy(), g.numpy()


def _jax_vjp(fn, x, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(_cl(x)))
    (g,) = vjp(jnp.asarray(_cl(cot)))
    return np.moveaxis(np.asarray(out), -1, 1), np.moveaxis(np.asarray(g), -1, 1)


# ---------------------------------------------------------------- the resizes


@pytest.mark.parametrize("depth,src,dst,prefix,hw", [
    (8, 8, 16, 5, (16, 16)),     # d4_c1's up2, the whole 8^3 bottleneck
    (3, 16, 32, 5, (32, 32)),    # d3_c1's: a 3-row prefix of 16
    (3, 64, 128, 4, (64, 64)),   # d1_c1's: a 3-row prefix of 64
])
def test_linear_depth_prefix_matches_jax(depth, src, dst, prefix, hw):
    """Output and the input's gradient under a random cotangent, each within
    1e-6 of its largest entry; a prefix too short for the rows asked for
    raises (JAX asserts)."""
    x = _normal((1, 4, depth, hw[0] // 2, hw[1] // 2), 1)
    cot = _normal((1, 4, prefix, *hw), 2)
    out, g = _port_vjp(lambda t: resize_linear_depth_prefix(t, src, dst, prefix, hw), x, cot)
    want, gw = _jax_vjp(
        lambda t: jax_resize.resize_linear_depth_prefix(t, src, dst, prefix, hw), x, cot)
    assert out.shape == want.shape == (1, 4, prefix, *hw)
    assert _rel(out, want) <= RESIZE_REL
    assert _rel(g, gw) <= RESIZE_REL
    with pytest.raises(ValueError, match="too small"):
        resize_linear_depth_prefix(torch.from_numpy(x[:, :, :1]), src, dst, prefix, hw)


@pytest.mark.parametrize("depth,dst,prefix,hw", [
    (3, 16, 4, (16, 16)),    # MMVit4's skips, and MMVit2's x1
    (3, 128, 3, (32, 32)),   # level 1's 3-row prefix
    (2, 32, 4, (16, 16)),    # MMVit2's x2
    (1, 64, 4, (8, 8)),      # MMVit2's x3 and x4
])
def test_nearest_depth_prefix_matches_jax(depth, dst, prefix, hw):
    """A selection: the output equal bit for bit, and the gradient (sums of
    the cotangent's entries that chose each row) within 1e-6."""
    x = _normal((1, 4, depth, hw[0] // 2, hw[1] // 2), 3)
    cot = _normal((1, 4, prefix, *hw), 4)
    out, g = _port_vjp(lambda t: resize_nearest_depth_prefix(t, dst, prefix, hw), x, cot)
    want, gw = _jax_vjp(
        lambda t: jax_resize.resize_nearest_depth_prefix(t, dst, prefix, hw), x, cot)
    np.testing.assert_array_equal(out, want)
    assert _rel(g, gw) <= RESIZE_REL


def test_uneven_replicate_padding_matches_jax():
    """The pruned chain's 3^3 conv, ``((1, 0), (1, 1), (1, 1))`` replicate
    padding, against JAX's ``Conv`` with the same pairs: one row fewer than
    the input, output and gradients within 1e-6 of their largest entries."""
    from corrifnet_tpu.nn import Conv as JaxConv

    pads = ((1, 0), (1, 1), (1, 1))
    conv = Conv(6, 5, 3, 1, pads, padding_mode="replicate")
    conv.reset_parameters(torch.Generator().manual_seed(5))
    x = _normal((1, 6, 4, 9, 9), 6)
    cot = _normal((1, 5, 3, 9, 9), 7)
    out, g = _port_vjp(conv, x, cot)
    params = {"kernel": jnp.asarray(conv.weight.detach().permute(2, 3, 4, 1, 0).numpy()),
              "bias": jnp.asarray(conv.bias.detach().numpy())}
    jc = JaxConv(5, 3, 1, pads, pad_mode="replicate")
    want, gw = _jax_vjp(lambda t: jc.apply({"params": params}, t), x, cot)
    assert out.shape == (1, 5, 3, 9, 9)
    assert _rel(out, want) <= RESIZE_REL
    assert _rel(g, gw) <= RESIZE_REL


# ---------------------------------------------------------------- the decoder

_MMVIT4_SKIPS = [(1, 24, 3, 16, 16), (1, 48, 3, 16, 16), (1, 96, 3, 8, 8),
                 (1, 192, 3, 4, 4), (1, 192, 8, 8, 8)]
_MMVIT2_SKIPS = [(1, 24, 3, 16, 16), (1, 48, 2, 8, 8), (1, 96, 1, 4, 4),
                 (1, 192, 1, 2, 2), (1, 192, 8, 8, 8)]


def _xla_epilogue(y):
    """K3's function with the JAX package's XLA statistics (single-pass),
    on channels-last ``y``: the JAX decoder's epilogue on the CPU."""
    ys, a, b = relu_in_stats(y.permute(0, 4, 1, 2, 3))
    return (ys * a + b).permute(0, 2, 3, 4, 1)


def _decoder(use_reduce):
    dec = DecoderFuse(depth_mode="pruned", use_reduce=use_reduce)
    g = torch.Generator().manual_seed(17)
    for m in dec.modules():
        if m is not dec and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return dec


def _port(dec, xs, dtype):
    """Output and the gradients of mean(out^2), under the port's names."""
    out = dec(*[torch.from_numpy(x).to(dtype) for x in xs])
    names = [f"decoder_fuse.{n}" for n, _ in dec.named_parameters()]
    grads = torch.autograd.grad((out * out).mean(), list(dec.parameters()))
    return out.detach().numpy(), {n: gr.numpy() for n, gr in zip(names, grads)}


def _jax(dec, xs, use_reduce, monkeypatch):
    """JAX's pruned decoder from the port's parameters in float64 throughout
    (every ``jnp.float32`` a ``jnp.float64``, the interpolation matrices
    built in float64): the output and the gradients of mean(out^2) under
    the port's names."""
    import corrifnet_tpu.nn.resize as jresize
    from corrifnet_tpu.models.decoder import DecoderFuse as JaxDecoder

    sd = {f"decoder_fuse.{k}": v for k, v in dec.state_dict().items()}
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          ti._decoder(sd, use_reduce=use_reduce))
    with jax.enable_x64(True), monkeypatch.context() as patch:
        patch.setattr(jnp, "float32", jnp.float64)
        patch.setattr(jresize, "np", _Float64Numpy())
        patch.setattr(jresize, "_linear_matrix", jresize._linear_matrix.__wrapped__)
        jm = JaxDecoder(depth_mode="pruned", use_reduce=use_reduce)

        def loss(p):
            y = jm.apply({"params": p}, *[jnp.asarray(_cl(x).astype(np.float64)) for x in xs],
                         True)
            return (y * y).mean(), y

        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        named = {}
        jax_import._decoder(named, jax.tree.map(np.asarray, grads))
    return np.asarray(want), {k: v.numpy() for k, v in named.items()}


class _Float64Numpy:
    """numpy whose ``float32`` is ``float64``."""

    def __getattr__(self, name):
        return np.float64 if name == "float32" else getattr(np, name)


@pytest.mark.parametrize("use_reduce", [True, False])
def test_pruned_decoder_matches_jax(use_reduce, monkeypatch):
    """The pruned cascade from the same parameters and skips, the port's
    chain ending in JAX's XLA epilogue (its K3 on the CPU computes the
    variance in two passes, the JAX package's XLA path in one), in float64
    on both sides (the port's ``.float()`` a ``.double()``): the output and
    the gradient of every parameter tensor under mean(out^2) within 1e-9 of
    its largest entry, the same function. (The f32 gradients of either side
    are up to 0.6% of a tensor's largest entry from float64: the prefix
    statistics over 2-5 rows are badly conditioned at random weights; the
    f32 forward is held against JAX's in the whole model,
    ``tests/test_torch_fusedbn.py``.) The pruned decoder runs the plain
    chain (never depth-fused, never lean) and its convs drop one depth row
    each (JAX ``decoder.py:106-124``)."""
    shapes = _MMVIT4_SKIPS if use_reduce else _MMVIT2_SKIPS
    xs = [_normal(s, 30 + i) for i, s in enumerate(shapes)]
    dec = _decoder(use_reduce)
    assert not dec.fuse_depth and not dec._uses_lean(1) and not dec._lean
    assert dec.d4_c2.conv.padding == ((1, 0), (1, 1), (1, 1))
    assert sorted(dec.state_dict()) == sorted(DecoderFuse(use_reduce=use_reduce).state_dict())
    monkeypatch.setattr(tconv, "relu_instancenorm", _xla_epilogue)

    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
        out, got = _port(dec.double(), xs, torch.float64)
    want, want_g = _jax(dec, xs, use_reduce, monkeypatch)
    assert out.shape == want.shape == (1, 3, 1, 224, 224)
    assert _rel(out, want) <= F64_RTOL
    assert sorted(got) == sorted(want_g)
    worst = max((_rel(got[n], want_g[n]), n) for n in want_g)
    assert worst[0] <= F64_RTOL, worst
