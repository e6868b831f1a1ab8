"""The port's fixed-order backwards, and the entry points' deterministic scope.

On the card a training run repeats its bits only where every backward runs
in a fixed order (``utils/determinism.py``). The port computes these
backwards itself, and each is held here, on the CPU in f32, against
``jax.vjp`` of the JAX package's function and against autograd of the
PyTorch op it stands for:

* the linear resize (products with the interpolation matrix, transposed in
  the backward) in 3-D and 2-D, with and without ``align_corners``;
* replicate padding in 2-D and 3-D (the border folded into the edge row);
* max pooling, on windows full of ties (the first largest entry in window
  order takes the gradient, as in both packages).

Then ``deterministic()`` and the two entry points: the flags are on while a
run's model computes and the caller's come back after, on success and on
error.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from corrifnet_tpu.nn import resize as jresize
from corrifnet_tpu_torch.nn.pad import replicate_pad
from corrifnet_tpu_torch.nn.resize import max_pool, resize_linear
from corrifnet_tpu_torch.utils.determinism import CUBLAS_WORKSPACE, deterministic
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# f32 reassociation: the products sum two taps per axis in another order
# than PyTorch's lerp and XLA's tensordot, each within a few ulps
REL = 2e-6


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cl(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def _ncl(x):
    return np.moveaxis(np.asarray(x), -1, 1)


def _port_vjp(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    return y.detach().numpy(), gx.numpy()


def _jax_vjp(fn, x, g):
    """fn on channels-last arrays, given and returning NC... arrays."""
    y, vjp = jax.vjp(fn, jnp.asarray(_cl(x)))
    (gx,) = vjp(jnp.asarray(_cl(g)))
    return _ncl(y), _ncl(gx)


@pytest.mark.parametrize("src,dst,align", [
    ((3, 8, 8), (8, 16, 16), True),     # the encoder's x6 pyramid, RFNet's cascade
    ((5, 6, 7), (9, 12, 4), False),
    ((14, 14), (28, 28), False),        # RobustMseg's mask decoder
    ((5, 9), (12, 4), True),
])
def test_resize_linear_backward_matches_jax_and_torch(src, dst, align):
    x = _normal((2, 3, *src), 0)
    g = _normal((2, 3, *dst), 1)
    y, gx = _port_vjp(lambda t: resize_linear(t, dst, align_corners=align), x, g)
    yj, gj = _jax_vjp(lambda t: jresize.resize_linear(t, dst, align_corners=align), x, g)
    mode = "trilinear" if len(src) == 3 else "bilinear"
    yt, gt = _port_vjp(lambda t: F.interpolate(t, dst, mode=mode, align_corners=align), x, g)
    errs = [_rel(y, yj), _rel(gx, gj), _rel(y, yt), _rel(gx, gt)]
    assert max(errs) <= REL, errs


@pytest.mark.parametrize("shape,pads", [
    ((2, 3, 3, 6, 7), ((1, 1), (1, 1), (1, 1))),
    ((2, 3, 1, 5, 5), ((1, 1), (1, 1), (1, 1))),  # a depth of 1: both borders fold in
    ((2, 3, 6, 7), ((1, 1), (2, 2))),
])
def test_replicate_pad_backward_matches_jax_and_torch(shape, pads):
    x = _normal(shape, 2)
    padded = [n + lo + hi for n, (lo, hi) in zip(shape[2:], pads)]
    g = _normal((*shape[:2], *padded), 3)
    y, gx = _port_vjp(lambda t: replicate_pad(t, pads), x, g)
    yj, gj = _jax_vjp(lambda t: jnp.pad(t, [(0, 0), *pads, (0, 0)], mode="edge"), x, g)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    yt, gt = _port_vjp(lambda t: F.pad(t, flat, mode="replicate"), x, g)
    assert np.array_equal(y, yj) and np.array_equal(y, yt)
    assert max(_rel(gx, gj), _rel(gx, gt)) <= REL, (_rel(gx, gj), _rel(gx, gt))


def test_replicate_pad_keeps_channels_last_gradient():
    """The gradient comes back in the input's memory format, as the
    channels-last volumes of the decoders are."""
    x = torch.randn(1, 4, 3, 5, 5).contiguous(memory_format=torch.channels_last_3d)
    x.requires_grad_()
    replicate_pad(x, [(1, 1)] * 3).sum().backward()
    assert x.grad.is_contiguous(memory_format=torch.channels_last_3d)
    assert replicate_pad(x, [(0, 0)] * 3) is x


@pytest.mark.parametrize("kind", ["ties", "constant"])
@pytest.mark.parametrize("window,strides,padding", [
    ((1, 3, 3), (1, 2, 2), (0, 1, 1)),  # the MMVit4 stem's
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
])
def test_max_pool_backward_ties_match_jax_and_torch(kind, window, strides, padding):
    """Windows full of equal entries (integers 0-2, or one constant): the
    gradient goes to the first largest entry of each window in window order,
    in the port, in JAX's ``reduce_window`` max and in PyTorch's op."""
    rng = np.random.default_rng(4)
    shape = (2, 3, 5, 9, 9)
    if kind == "ties":
        x = rng.integers(0, 3, shape).astype(np.float32)
    else:
        x = np.full(shape, 0.5, np.float32)
    out = [(n + 2 * p - k) // s + 1 for n, k, s, p in zip(shape[2:], window, strides, padding)]
    g = _normal((*shape[:2], *out), 5)
    y, gx = _port_vjp(lambda t: max_pool(t, window, strides, padding), x, g)
    yj, gj = _jax_vjp(lambda t: jresize.max_pool(t, window, strides, padding), x, g)
    yt, gt = _port_vjp(lambda t: F.max_pool3d(t, window, strides, padding), x, g)
    assert np.array_equal(y, yj) and np.array_equal(y, yt)
    # each input entry sums at most 8 window gradients: a few f32 ulps
    assert max(_rel(gx, gj), _rel(gx, gt)) <= REL, (_rel(gx, gj), _rel(gx, gt))
    # the same entries receive gradient on all three sides
    assert np.array_equal(gx != 0, gj != 0) and np.array_equal(gx != 0, gt != 0)


def _flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.utils.deterministic.fill_uninitialized_memory,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


# deterministic algorithms, not warn-only, cuDNN deterministic, no
# benchmarking, no NaN fill of new allocations, the cuBLAS workspace
IN_SCOPE = (True, False, True, False, False, CUBLAS_WORKSPACE)


@pytest.fixture
def caller_flags(monkeypatch):
    """The caller's settings as a benchmark leaves them (cuDNN benchmarking
    on), restored after the test."""
    before = _flags()
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.utils.deterministic.fill_uninitialized_memory = True
    yield _flags()
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2:4]
    torch.utils.deterministic.fill_uninitialized_memory = before[4]


def test_scope_sets_and_restores(caller_flags, monkeypatch):
    with deterministic():
        assert _flags() == IN_SCOPE
    assert _flags() == caller_flags
    with pytest.raises(ValueError):
        with deterministic(warn_only=True):
            assert _flags()[:2] == (True, True)
            raise ValueError
    assert _flags() == caller_flags
    # a workspace the caller set is kept, and stays after
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with deterministic():
        assert _flags()[5] == ":16:8"
    assert _flags()[5] == ":16:8"


def test_entry_points_run_inside_the_scope(caller_flags, tmp_path, monkeypatch):
    """``run.main`` and ``run.evaluate`` compute their model's forwards
    with the flags on, and hand the caller's back."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import evaluate, main
    from torch_tiny_model import TinySeg5D
    from corrifnet_tpu_torch.models import registry

    seen = []

    class Probe(TinySeg5D):
        def forward(self, x):
            seen.append(_flags())
            return super().forward(x)

    monkeypatch.setitem(registry._REGISTRY, "Probe", registry.ModelSpec("Probe", Probe, "5d"))
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "n_epochs": 1, "modeltype": "Probe", "synthetic_seed": 0,
         "dtype": "float32"}))
    main.main(["--config", "cfg.json", "--device", "cpu"])
    n_train = len(seen)
    evaluate.main(["--config", "cfg.json", "--device", "cpu"])
    assert n_train and len(seen) > n_train
    assert set(seen) == {IN_SCOPE}
    assert _flags() == caller_flags
