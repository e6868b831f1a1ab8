"""A 4-D zoo model of the port against the JAX package, on the CPU in f32.

Shared by ``tests/test_torch_elanet.py``, ``tests/test_torch_fassdnet.py``
and ``tests/test_torch_enet.py``, and for its step by
``tests/test_torch_multisenseseg_options.py`` (a 5-D model built with
options: ``Zoo.build``, ``input_kind``, ``channels_last``). A ``Zoo`` names
the model, its JAX module and the converters both ways. The JAX side always gets the port's
weights through ``corrifnet_tpu.models.torch_import``, never an eager init;
its abstract shapes come from ``jax.eval_shape``.

* ``check_whole_model``: the forward at B=1 in eval mode, ELANet's and
  FASSDNet's BatchNorms calibrated to O(1) activations
  (``testing.calibrate_batchnorm``: at identity statistics ELANet's sigmoid
  saturates, a quarter to a half of its outputs beyond 0.01 or 0.99, and
  FASSDNet's output is flat, 0.5053 to 0.5056; ENet's spreads over 0.45 to
  0.55 as built and is left so: calibrated, it reaches 0.994), within
  MODEL_ATOL or twice the port's own change under a 1e-6 change of the
  input;
* ``check_train_step``: one training-mode step, BatchNorm on batch
  statistics, every dropout site given the same masks in call order on
  both sides (``torch_zoo_step.CallOrderMasks``). The port's and the JAX
  package's step in float64 (every ``.float()`` a ``.double()``;
  ``jax_enable_x64``, every ``jnp.float32`` a ``jnp.float64`` and the
  interpolation matrices built in float64) agree to F64_RTOL per gradient
  tensor: the same function. The port's f32 loss is held within 1e-5 of
  JAX's and its f32 gradients to ``torch_zoo_step.hold_step``'s bounds,
  both against JAX in float64: JAX's own f32 gradients are no yardstick
  here, ENet's shared PReLU slopes (sums over 10^5 terms that cancel)
  coming out up to 47% from float64 in them where the port's are within
  1e-4. ``hold_step``'s own float64 fallback replays the f32 step's ReLU
  and PReLU choices (``Branch``). The tensors that
  ``testing.zero_gradients`` names are exactly those of JAX's gradient
  that are 0 but for rounding, less those that are exactly 0 on both
  sides (an ELANet CCA whose ReLU is dead for the data: its 1-D conv of
  the positive channel means is negative everywhere where its taps sum to
  less than 0, as they do for about half of the random draws);
* ``check_round_trip``: the ``state_dict`` both ways, bit for bit, and the
  parameter count of the JAX tree;
* ``check_notr``: ``apply_reference_init_scheme`` re-initializes exactly
  the JAX package's tensors and draws with the scheme's deviation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu_torch.models import create_model
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.nn import PReLU
from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
from corrifnet_tpu_torch.testing import calibrate_batchnorm, zero_gradients
from corrifnet_tpu_torch.train import masked_loss_and_jaccard
from torch_zoo_step import (
    CallOrderMasks,
    hold_scheme_std,
    hold_step,
    jax_reinitialized,
)

F32 = jnp.float32
MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
F64_RTOL = 1e-9  # per gradient tensor, the port against JAX, both in float64
TINY = 1e-6  # of the largest gradient entry: see tiny_gradients


@dataclasses.dataclass(frozen=True)
class Zoo:
    name: str
    jax_model: Callable  # dtype -> the JAX module (None: the input's dtype)
    to_variables: Callable  # port state_dict -> JAX variables (torch_import)
    to_state_dict: Callable  # JAX variables -> port state_dict (jax_import)
    calibrate: bool = True  # the whole-model check on calibrated BatchNorms
    build: Callable = None  # seed -> the port's model (create_model's by default)
    input_kind: str = "4d"  # '5d': (B, 3 modalities, 3 bands, H, W) inputs
    channels_last: bool = True  # CallOrderMasks' layout (see torch_zoo_step)

    def shapes(self):
        return jax.eval_shape(lambda: self.jax_model(F32).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64), F32)))

    def model(self, seed):
        return self.build(seed) if self.build else create_model(self.name, seed=seed)

    def gradients(self, grads):
        return self.to_state_dict({"params": grads})


def nhwc(t):
    return jnp.asarray(np.moveaxis(np.asarray(t), 1, -1))


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def inputs(seed, b=1, hw=64, kind="4d"):
    rng = np.random.default_rng(seed)
    lead = (b, 3, 3) if kind == "5d" else (b, 3)
    x = rng.normal(0, 1, (*lead, hw, hw)).astype(np.float32)
    masks = (rng.random((*lead[:-1], 1, hw, hw)) > 0.7).astype(np.float32)
    return x, masks, np.ones(b, np.float32)


def check_whole_model(zoo, hw, seed=0):
    """The forward check above; returns the error."""
    model = create_model(zoo.name, seed=seed)
    x, _, _ = inputs(11, hw=hw)
    if zoo.calibrate:
        calibrate_batchnorm(model, torch.from_numpy(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        witness = np.abs(model(torch.from_numpy(x * np.float32(1 + 1e-6))).numpy()
                         - got).max()
    want = np.asarray(jax.jit(lambda v, xx: zoo.jax_model(F32).apply(v, xx, False))(
        zoo.to_variables(model.state_dict()), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 1, hw, hw) and np.isfinite(got).all()
    assert 0.01 < got.min() and got.max() < 0.99 and got.max() - got.min() > 0.05
    err = np.abs(got - want).max()
    print(f"{zoo.name} {hw}x{hw} forward against JAX:", err, "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)
    return err


def port_step(model, masks, valid, seed, branch=None, channels_last=True):
    """``step(x)``: the port's (loss, {name: gradient}) of one training-mode
    step, the dropout masks from ``CallOrderMasks(seed)``, with PyTorch's
    own CPU convolutions: oneDNN's backward of ELANet's convs is 0.5% of a
    tensor's norm from float64 where PyTorch's is 1e-5, as JAX's is. With
    a ``Branch``, an f32 step records its choices while ``branch.record``
    is set, and a float64 step replays them."""

    def step(xx):
        model.set_dropout_rng(CallOrderMasks(seed, channels_last=channels_last))
        model.train()
        model.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.backends.mkldnn.flags(enabled=False))
            if branch is not None:
                branch.patch(stack.enter_context(pytest.MonkeyPatch.context()),
                             f64=xx.dtype == np.float64)
            out = model(torch.from_numpy(xx)).float()
            loss, _, _ = masked_loss_and_jaccard(out, torch.from_numpy(masks).to(out.dtype),
                                                 torch.from_numpy(valid).to(out.dtype))
            loss.backward()
        return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                             if p.grad is not None}

    return step


def jax_step(zoo, model, x, masks, valid, seed, monkeypatch):
    """JAX's loss and gradients (under the port's names) of the same step in
    float64 throughout, its dropout masks answered from
    ``CallOrderMasks(seed)``, and the table."""
    import corrifnet_tpu.nn.resize as jresize
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard

    variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                             zoo.to_variables(model.state_dict()))
    table = CallOrderMasks(seed, channels_last=zoo.channels_last)
    with jax.enable_x64(True), monkeypatch.context() as patch:
        patch.setattr(jax.random, "bernoulli", table.bernoulli)
        patch.setattr(jnp, "float32", jnp.float64)
        # the interpolation matrices, built with numpy in float32, uncached
        patch.setattr(jresize, "np", _Float64Numpy())
        patch.setattr(jresize, "_linear_matrix", jresize._linear_matrix.__wrapped__)
        jm = zoo.jax_model(None)

        def loss_fn(params, stats, xx):
            out, _ = jm.apply({"params": params, "batch_stats": stats}, xx, True,
                              rngs={"dropout": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
            return _masked_loss_and_jaccard(out, jnp.asarray(masks, np.float64),
                                            jnp.asarray(valid, np.float64))[0]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"], variables["batch_stats"], jnp.asarray(x, np.float64))
        grads = jax.tree.map(np.asarray, grads)
    return float(loss), {k: v.numpy() for k, v in zoo.gradients(grads).items()}, table


class _Float64Numpy:
    """numpy whose ``float32`` is ``float64``."""

    def __getattr__(self, name):
        return np.float64 if name == "float32" else getattr(np, name)


def port_f64(step, model, x, monkeypatch):
    """``step(x)`` of the port in float64, as ``hold_step`` runs it."""
    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
        model.double().compute_dtype = torch.float64
        try:
            return step(x.astype(np.float64))
        finally:
            model.float().compute_dtype = torch.float32


def tiny_gradients(want):
    """The names of JAX's gradient tensors within TINY of its largest entry:
    those that are 0 but for rounding (1e-17 of it in ELANet's float64
    gradient; 1e-8 in f32). The smallest live tensors of these models sit at
    1e-5 (ELANet's stage-3 BatchNorm scales), below ``hold_step``'s
    ZERO_NOISE, so the split is drawn lower."""
    scale = max(float(np.abs(v).max()) for v in want.values())
    return {n for n, v in want.items() if float(np.abs(v).max()) <= TINY * scale}


class Branch:
    """The discrete choices of one f32 step of the port, recorded, and
    replayed in its float64 step: the sign of every ReLU and PReLU input
    and ENet's pool indices. At random initialization a few ReLU or PReLU
    inputs of a forward lie within f32's rounding drift of 0 (1e-5 deep in
    ELANet and FASSDNet; one to five in each 64x64 forward at B=2), and the
    float64 step takes the other side of some of them: a flip moves a small
    gradient tensor (a BatchNorm bias's, a sum of cancelling terms) by
    several percent, though both steps are right. The float64 step that
    ``hold_step`` falls back on then replays the f32 step's choices: it is
    the exact gradient of the same piece of the piecewise-linear model,
    against which the port's f32 step differs by rounding alone and JAX's
    by rounding and its own flips."""

    def __init__(self):
        self.record = False
        self.seen = []
        self.at = 0

    def _next(self, kind):
        got, value = self.seen[self.at]
        assert got == kind, (got, kind)
        self.at += 1
        return value

    def patch(self, patch, f64):
        """Record (``self.record``) or, with ``f64``, replay from the start."""
        import corrifnet_tpu_torch.models.enet as enet

        if not (self.record or f64):
            return
        relu, prelu, pool = torch.relu, PReLU.forward, enet.max_pool_argmax
        if self.record:
            self.seen = []

            def relu_(t):
                self.seen.append(("relu", t.detach() > 0))
                return relu(t)

            def prelu_(mod, t):
                self.seen.append(("prelu", torch.sign(t.detach())))
                return prelu(mod, t)

            def pool_(*args):
                out = pool(*args)
                self.seen.append(("pool", out[1]))
                return out
        else:
            self.at = 0

            def relu_(t):
                return torch.where(self._next("relu"), t, 0.0)

            def prelu_(mod, t):
                sign = self._next("prelu")
                w = mod.weight.to(t.dtype).view(1, -1, *(1,) * (t.dim() - 2))
                return torch.where(sign > 0, t, torch.where(sign < 0, w * t, prelu(mod, t)))

            def pool_(x, *args):
                idx = self._next("pool")
                b, c = idx.shape[:2]
                vals = x.reshape(b, c, -1).gather(2, idx.reshape(b, c, -1))
                return vals.view(idx.shape), idx
        patch.setattr(torch, "relu", relu_)
        patch.setattr(PReLU, "forward", prelu_)
        patch.setattr(enet, "max_pool_argmax", pool_)


def check_train_step(zoo, monkeypatch, seed, b=2, hw=64, model_seed=2, live=()):
    """The step check above at batch ``b``; returns the dropout calls.
    ``live``: names of ``testing.zero_gradients`` that the step's data
    makes live, held as every other tensor."""
    model = zoo.model(model_seed)
    x, masks, valid = inputs(131 + seed, b=b, hw=hw, kind=zoo.input_kind)
    loss_j64, want, table_j = jax_step(zoo, model, x, masks, valid, seed, monkeypatch)
    loss_64, got_64 = port_f64(port_step(model, masks, valid, seed,
                                         channels_last=zoo.channels_last),
                               model, x, monkeypatch)
    branch = Branch()
    step = port_step(model, masks, valid, seed, branch, zoo.channels_last)
    branch.record = True
    loss, got = step(x)
    branch.record = False
    assert table_j.calls == dropout_calls(model)
    _, moved = step(x * np.float32(1 + 1e-6))
    names = sorted(n for n, _ in model.named_parameters())
    assert sorted(got) == sorted(got_64) == names and set(names) <= set(want)
    want = {n: want[n] for n in names}
    assert abs(loss - loss_j64) <= 1e-5, (loss, loss_j64)
    assert abs(loss_64 - loss_j64) <= 1e-12, (loss_64, loss_j64)
    zero = [n for n in zero_gradients(model, batch=b) if n not in live]
    scale = max(float(np.abs(v).max()) for v in want.values())
    f64 = max((_distance(got_64[n], want[n]), n) for n in names if n not in zero)
    noise = max([float(np.abs(got_64[n]).max()) / scale for n in zero] or [0.0])
    print(f"{zoo.name} B={b} step, port against JAX in float64: worst {f64}, the zero "
          f"gradients {noise} of the largest entry")
    assert f64[0] <= F64_RTOL and noise <= F64_RTOL, (f64, noise)
    dead = {n for n in names if not want[n].any() and not got[n].any()}
    assert tiny_gradients(want) - dead == set(zero), sorted(tiny_gradients(want) ^ set(zero))
    hold_step(zoo.name, model, step, x, got, want, moved, monkeypatch, zero)
    return table_j.calls


def _distance(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def dropout_calls(model):
    """The (shape, keep probability) calls of the one ``CallOrderMasks``
    that the model's dropout sites hold (none: FASSDNet has no site)."""
    rngs = {id(m.rng): m.rng for m in model.modules() if getattr(m, "rng", None) is not None}
    assert len(rngs) <= 1
    return next(iter(rngs.values())).calls if rngs else []


def check_round_trip(zoo, n_params):
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit: the port's
    state_dict converts into a tree of exactly the JAX init tree's
    structure, with ``n_params`` parameters, and back; returns the
    state_dict."""
    shapes = zoo.shapes()
    model = create_model(zoo.name, seed=1)
    assert sum(p.numel() for p in model.parameters()) == n_params
    sd = model.state_dict()
    want_shapes = {k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))).items()}
    variables = zoo.to_variables(sd)
    assert {k: v.shape for k, v in flatten_variables(variables).items()} == want_shapes
    assert sum(math.prod(s) for k, s in want_shapes.items()
               if k.startswith("params/")) == n_params
    back = zoo.to_state_dict(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())

    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32), dict(shapes))
    model.load_state_dict(zoo.to_state_dict(tree), strict=True)
    want, got = flatten_variables(tree), flatten_variables(zoo.to_variables(model.state_dict()))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    return sd


def check_notr(zoo, scheme, n_kernels):
    """``apply_reference_init_scheme`` re-initializes exactly the
    ``n_kernels`` 4-axis kernels of the JAX tree and zeroes the biases
    beside them, leaves every other tensor as built, and draws with the
    scheme's standard deviation; returns the names."""
    model = create_model(zoo.name, seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = apply_reference_init_scheme(model, scheme, torch.Generator().manual_seed(3))
    want = jax_reinitialized(zoo.shapes()["params"], zoo.to_state_dict)
    assert len(names) == n_kernels and set(names) == {n for n in want if n.endswith(".weight")}
    params = dict(model.named_parameters())
    for n in before:
        assert torch.equal(params[n], before[n]) == (n not in want), n
    assert all(not params[n].any() for n in want if n.endswith(".bias"))
    hold_scheme_std(scheme, [params[n] for n in names])
    return names
