"""The port's block library (``models/extras.py``) against the JAX
package's (``corrifnet_tpu/models/extras.py``), on the CPU in f32.

Each block at the shapes of ``tests/test_extras.py``: the JAX block is
initialized (its BatchNorm affines and running statistics then drawn at
random, so that eval mode normalizes with something), converted by
``extras_state_dict_from_variables`` into the port's block, and both run
the same seeded inputs. The outputs agree to 2e-5: the BatchNorm blocks in
eval mode and in train mode (batch statistics; the running statistics
after the forward agree too), the attention blocks with
``deterministic=True`` (they have no dropout). The three Swin names are
the ones ``models/multisenseseg.py`` defines.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import extras as jx
from corrifnet_tpu_torch.models import extras as px
from corrifnet_tpu_torch.models import multisenseseg as pm
from corrifnet_tpu_torch.models.jax_import import extras_state_dict_from_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

ATOL = 2e-5


@dataclasses.dataclass(frozen=True)
class Case:
    jax_block: Callable
    port_block: Callable
    shapes: tuple  # the JAX inputs' shapes: channels-last images or tokens
    image: bool = True  # NHWC inputs and outputs, and a train argument


CASES = {
    "BasicBlock2d": Case(lambda: jx.BasicBlock2d(planes=32, stride=2),
                         lambda: px.BasicBlock2d(16, 32, 2), ((2, 8, 8, 16),)),
    "BasicBlock2d_identity": Case(lambda: jx.BasicBlock2d(planes=16, no_relu=True),
                                  lambda: px.BasicBlock2d(16, 16, no_relu=True),
                                  ((2, 8, 8, 16),)),
    "Bottleneck2d": Case(lambda: jx.Bottleneck2d(planes=16),
                         lambda: px.Bottleneck2d(16, 16), ((2, 8, 8, 16),)),
    "Bottleneck2d_stride": Case(lambda: jx.Bottleneck2d(planes=8, stride=2, no_relu=False),
                                lambda: px.Bottleneck2d(16, 8, 2, no_relu=False),
                                ((2, 8, 8, 16),)),
    "SegmentHead": Case(lambda: jx.SegmentHead(interplanes=16, outplanes=2, scale_factor=4),
                        lambda: px.SegmentHead(32, 16, 2, 4), ((1, 8, 8, 32),)),
    "DAPPM": Case(lambda: jx.DAPPM(branch_planes=24, outplanes=64),
                  lambda: px.DAPPM(64, 24, 64), ((1, 32, 32, 64),)),
    "PAPPM": Case(lambda: jx.PAPPM(branch_planes=16, outplanes=40),
                  lambda: px.PAPPM(32, 16, 40), ((1, 64, 64, 32),)),
    "PagFM": Case(lambda: jx.PagFM(mid_channels=4), lambda: px.PagFM(8, 4),
                  ((1, 16, 16, 8), (1, 8, 8, 8))),
    "PagFM_with_channel": Case(
        lambda: jx.PagFM(mid_channels=4, after_relu=True, with_channel=True),
        lambda: px.PagFM(8, 4, after_relu=True, with_channel=True),
        ((1, 16, 16, 8), (1, 8, 8, 8))),
    "Bag": Case(lambda: jx.Bag(out_channels=16), lambda: px.Bag(16, 16),
                ((1, 8, 8, 16),) * 3),
    "CrossAttention": Case(lambda: jx.CrossAttention(dim=32, num_heads=4, qkv_bias=True),
                           lambda: px.CrossAttention(32, 4, qkv_bias=True), ((2, 10, 32),),
                           image=False),
    "Block": Case(lambda: jx.Block(dim=32, num_heads=4, mlp_ratio=2.0),
                  lambda: px.Block(32, 4, 2.0), ((2, 10, 32),), image=False),
    "CrossAttentionBlock": Case(lambda: jx.CrossAttentionBlock(dim=32, num_heads=4),
                                lambda: px.CrossAttentionBlock(32, 4), ((2, 10, 32),),
                                image=False),
    "MultiScaleBlock": Case(
        lambda: jx.MultiScaleBlock(dims=(32, 48), depths=(1, 1, 2), num_heads=(4, 6),
                                   mlp_ratios=(2.0, 2.0, 2.0)),
        lambda: px.MultiScaleBlock((32, 48), (1, 1, 2), (4, 6), (2.0, 2.0, 2.0)),
        ((2, 17, 32), (2, 25, 48)), image=False),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in case.shapes]


def _randomized(variables, seed=1):
    """The JAX variables with every BatchNorm's affine and running
    statistics drawn at random."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))

    def draw(p, s):
        for name, sub in p.items():
            if isinstance(sub, dict) and name in s and "mean" in s[name]:
                c = sub["scale"].shape
                sub["scale"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.5, c).astype(np.float32)
                s[name]["mean"] = rng.normal(0, 0.5, c).astype(np.float32)
                s[name]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(sub, dict) and name in s:
                draw(sub, s[name])

    draw(params, stats)
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def _jax_apply(case, variables, xs, train):
    block = case.jax_block()
    args = [jnp.asarray(x) for x in xs]
    if not case.image:
        args = [tuple(args)] if len(args) > 1 else args
        return jax.jit(lambda v: block.apply(v, *args))(variables), None
    if train:
        out, state = jax.jit(lambda v: block.apply(v, *args, True, mutable=["batch_stats"]))(
            variables)
        return out, state["batch_stats"]
    return jax.jit(lambda v: block.apply(v, *args, False))(variables), None


def _port_apply(case, block, xs):
    args = [torch.from_numpy(np.moveaxis(x, -1, 1).copy() if case.image else x) for x in xs]
    with torch.no_grad():
        out = block(tuple(args)) if (not case.image and len(args) > 1) else block(*args)
    outs = out if isinstance(out, list) else [out]
    return [np.moveaxis(o.numpy(), 1, -1) if case.image else o.numpy() for o in outs]


# the BatchNorm blocks in both modes; the attention blocks have no mode
RUNS = [(name, train) for name in sorted(CASES)
        for train in ((False, True) if CASES[name].image else (False,))]


@pytest.mark.parametrize("name,train", RUNS,
                         ids=[f"{n}-{'train' if t else 'eval'}" for n, t in RUNS])
def test_block_matches_jax(name, train):
    case = CASES[name]
    xs = _inputs(case)
    args = [jnp.asarray(x) for x in xs]
    init_args = ([tuple(args)] if len(args) > 1 else args) if not case.image else [*args, False]
    variables = _randomized(jax.jit(lambda key: case.jax_block().init(key, *init_args))(
        jax.random.PRNGKey(0)))
    block = case.port_block()
    block.load_state_dict(extras_state_dict_from_variables(variables), strict=True)
    block.train(train)
    want, stats = _jax_apply(case, variables, xs, train)
    got = _port_apply(case, block, xs)
    want = [np.asarray(w) for w in (want if isinstance(want, (list, tuple)) else [want])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(w).all()
        err = np.abs(g - w).max()
        print(f"{name} ({'train' if train else 'eval'}) against JAX:", g.shape, err,
              np.abs(w).max())
        assert err <= ATOL, (name, err)
    if stats is not None:
        new = extras_state_dict_from_variables({"params": variables["params"],
                                                "batch_stats": stats})
        buffers = dict(block.named_buffers())
        assert sorted(k for k in new if "running" in k) == sorted(buffers)
        for key, value in buffers.items():
            np.testing.assert_allclose(value.numpy(), new[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_every_jax_block_has_its_port():
    assert set(px.__all__) == set(jx.__all__)
    blocks = {n for n in jx.__all__ if n not in ("SwinBlock", "PatchMerging",
                                                  "WindowAttention")}
    assert blocks == {name.split("_")[0] for name in CASES}


def test_swin_names_are_multisenseseg_s():
    assert px.SwinBlock is pm.BasicBlock
    assert px.PatchMerging is pm.PatchMerging
    assert px.WindowAttention is pm.WindowAttention


def test_reset_parameters_draws_every_tensor():
    block = px.DAPPM(16, 8, 16).reset_parameters(torch.Generator().manual_seed(0))
    for name, p in block.named_parameters():
        assert torch.isfinite(p).all(), name
    conv = block.scale0_conv.weight
    assert 0 < conv.abs().max() <= 16 ** -0.5
