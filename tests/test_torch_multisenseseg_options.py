"""MultiSenseSeg's two options, ``use_faster`` (the CNN backbone) and
``aux`` (the auxiliary head), against the JAX package, on the CPU in f32.

The JAX package's own converter reads neither option, so the JAX side gets
the port's weights through the inverse of the port's converter
(``multisenseseg_state_dict_from_variables``), traced: a tree of element
ids converted once gives, for each port tensor, the JAX leaf elements it
holds; that every id comes back once shows the converter a bijection
between the two layouts.

* The ``state_dict`` both ways, bit for bit, for ``use_faster`` + ``aux``.
* The whole forward at B=1, 64x64, with ``use_faster`` and with
  ``use_faster`` + ``aux``, in eval mode and in train mode (BatchNorm on
  batch statistics, AMM's two dropout sites given the same masks in call
  order on both sides): the probabilities within
  ``test_torch_multisenseseg``'s MODEL_ATOL (or twice the witness), and
  the aux map, read with ``capture_aux``, against JAX's sown
  ``intermediates/aux_out``.
* One training step with ``use_faster`` at B=2 through
  ``torch_zoo_model.check_train_step``: both packages in float64 to
  F64_RTOL, the port's f32 loss within 1e-5 and its f32 gradients to
  ``torch_zoo_step.hold_step``'s bounds against JAX's float64 gradients.
  At B=1 the decode gate's SE reads the mean of a training-mode
  BatchNorm's output over the one image, which is that norm's bias (0)
  plus rounding, so the sign of its ReLU6's input is rounding, which the
  two packages draw differently even in float64: the gradient of
  ``build_decode_head.conv.1.bias`` moves by 17% with it. At B=2 the mean
  is one sample's and the step is well defined.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import multisenseseg as jm
from corrifnet_tpu_torch.models import multisenseseg as pm
from corrifnet_tpu_torch.models import multisenseseg_state_dict_from_variables
from corrifnet_tpu_torch.models.jax_import import flatten_variables, unflatten_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_model import Zoo, check_train_step, inputs
from torch_zoo_step import CallOrderMasks

MODEL_ATOL = 5e-5  # test_torch_multisenseseg's whole-model bound
AUX_ATOL = 5e-5
F32 = jnp.float32


def jax_model(use_faster, aux, dtype=F32):
    return jm.MultiSenseSeg(use_faster=use_faster, aux=aux, dtype=dtype)


def port_model(use_faster, aux, seed):
    model = pm.MultiSenseSeg(use_faster=use_faster, aux=aux)
    return model.reset_parameters(torch.Generator().manual_seed(seed))


def _flat_shapes(tree, prefix=""):
    """{'params/.../kernel': shape} of a tree of ``jax.ShapeDtypeStruct``."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        flat.update(_flat_shapes(v, key) if hasattr(v, "items") else {key: tuple(v.shape)})
    return flat


class Inverse:
    """Port state_dict -> JAX variables of the tree ``shapes``, by tracing
    ``to_state_dict`` on a tree whose leaves hold their elements' ids."""

    def __init__(self, shapes, to_state_dict):
        shapes_flat = _flat_shapes(shapes)
        self.shapes = shapes_flat
        self.sizes = {k: math.prod(s) for k, s in shapes_flat.items()}
        ids, offset = {}, 0
        for key, shape in shapes_flat.items():
            ids[key] = np.arange(offset, offset + self.sizes[key],
                                 dtype=np.float64).reshape(shape)
            offset += self.sizes[key]
        self.total = offset
        traced = to_state_dict(unflatten_variables(ids))
        self.index = {k: v.numpy().astype(np.int64).ravel() for k, v in traced.items()}
        self.port_shapes = {k: tuple(v.shape) for k, v in traced.items()}

    def covered_once(self):
        seen = np.concatenate(list(self.index.values()))
        return len(seen) == self.total and np.array_equal(np.sort(seen),
                                                          np.arange(self.total))

    def __call__(self, state_dict):
        buf = np.empty(self.total, np.float64)
        for key, idx in self.index.items():
            buf[idx] = state_dict[key].detach().double().numpy().ravel()
        dtype = np.float64 if all(v.dtype == torch.float64 for v in state_dict.values()
                                  if v.is_floating_point()) else np.float32
        flat, offset = {}, 0
        for key, shape in self.shapes.items():
            flat[key] = buf[offset:offset + self.sizes[key]].reshape(shape).astype(dtype)
            offset += self.sizes[key]
        return unflatten_variables(flat)


def inverse(aux):
    """The ``Inverse`` of the ``use_faster`` model's tree, with ``aux``."""
    shapes = jax.eval_shape(lambda: jax_model(True, aux).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 64, 64), F32)))
    return Inverse(shapes, multisenseseg_state_dict_from_variables)


@pytest.fixture(scope="module")
def inverses():
    return {aux: inverse(aux) for aux in (False, True)}


def test_state_dict_round_trip_is_exact(inverses):
    inv = inverses[True]
    assert inv.covered_once()
    model = port_model(True, True, 1)
    sd = model.state_dict()
    assert sorted(inv.port_shapes) == sorted(sd)
    assert all(inv.port_shapes[k] == tuple(v.shape) for k, v in sd.items())
    back = multisenseseg_state_dict_from_variables(inv(sd))
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    assert any(k.startswith("build_pipeline.layer4_block2.c2") for k in sd)
    assert {k for k in sd if k.startswith("aux_")} == {
        "aux_conv.0.weight", "aux_conv.1.weight", "aux_conv.1.bias",
        "aux_conv.1.running_mean", "aux_conv.1.running_var", "aux_head.weight",
        "aux_head.bias"}
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for k, v in flatten_variables(inv(sd)).items() if k.startswith("params/"))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("aux", [False, True], ids=["use_faster", "use_faster_aux"])
def test_forward_matches_jax(aux, train, inverses, monkeypatch):
    model = port_model(True, aux, 0)
    variables = inverses[aux](model.state_dict())
    x, _, _ = inputs(11, kind="5d")
    jmod = jax_model(True, aux)
    table_j, seed = CallOrderMasks(5), 5
    mutable = ["intermediates"] + (["batch_stats"] if train else [])
    with monkeypatch.context() as patch:
        patch.setattr(jax.random, "bernoulli", table_j.bernoulli)
        want, state = jax.jit(lambda v, xx: jmod.apply(
            v, xx, train, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=mutable))(
            variables, jnp.asarray(x))

    def port(xx):
        model.train(train).set_dropout_rng(CallOrderMasks(seed))
        with torch.no_grad():
            if not aux:
                return model(torch.from_numpy(xx)).numpy(), None
            with model.capture_aux() as seen:
                out = model(torch.from_numpy(xx)).numpy()
            return out, seen["aux_out"].numpy()

    got, got_aux = port(x)
    moved, _ = port(x * np.float32(1 + 1e-6))
    witness = np.abs(moved - got).max()
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 3, 1, 64, 64) and np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"MultiSenseSeg use_faster aux={aux} train={train} against JAX:", err,
          "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)
    if train:  # AMM's attention and projection dropout, the same masks
        assert len(table_j.calls) == 2
    if aux:
        (want_aux,) = state["intermediates"]["aux_out"]
        want_aux = np.asarray(want_aux)
        assert got_aux.shape == want_aux.shape == (1, 1, 4, 4)
        err = np.abs(got_aux - want_aux).max()
        print("aux map against JAX's sown aux_out:", err, np.abs(want_aux).max())
        assert err <= AUX_ATOL, err
    else:
        assert "aux_out" not in state.get("intermediates", {})


def test_capture_aux_needs_the_aux_head():
    with pytest.raises(ValueError, match="aux=True"):
        with port_model(True, False, 0).capture_aux():
            pass


def test_train_step_with_use_faster_matches_jax(inverses, monkeypatch):
    zoo = Zoo("MultiSenseSeg",
              jax_model=lambda dtype: jax_model(True, False, dtype),
              to_variables=inverses[False],
              to_state_dict=multisenseseg_state_dict_from_variables,
              build=lambda seed: port_model(True, False, seed),
              input_kind="5d", channels_last=False)
    # smooth's BatchNorm bias is 0 but for rounding only where every
    # MaxPool(4) window of its ReLU'd output holds a positive entry
    # (testing.zero_gradients); in this step some window is all 0, and the
    # bias is live: 2.4e-6 of the largest entry in float64 in both packages
    calls = check_train_step(zoo, monkeypatch, seed=3, b=2,
                             live=("build_MSEs_AMM.smooth.1.bias",))
    assert len(calls) == 2  # AMM's two dropout sites
