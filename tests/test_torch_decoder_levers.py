"""The decoder's memory levers against the JAX package, on the CPU.

* ``remat_convs`` (``decoder_remat``): every chain stage of a non-lean
  cascade (pruned, and the full fused chain) rematerialized in the
  backward gives the same output and the same gradients bit for bit, and
  runs the 12 chain epilogues again in the backward (27 + 12 calls);
* ``depth_chunks``: one chunked lean stage of each kind against JAX's, in
  float64;
* ``c2_chunks`` (``decoder_chunk``): the lean cascade with ``d2_c2`` in 4
  depth chunks and ``d1_c2``, ``d1_out`` in 8 against the same cascade
  unchunked and against JAX's chunked cascade from the same parameters.

The cascade is the small one of ``tests/test_lean_decoder.py`` at B=1 (its
depth and the H/W of its chain are the decoder's own, 8 -> 128). Inputs are
made from a numpy seed and fed to both sides. Each test states its
tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models.decoder import DecoderFuse
from corrifnet_tpu_torch.nn import conv as tconv
from corrifnet_tpu_torch.nn.leandec import relu_in_stats
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

CHUNK_OUT = 2e-6   # chunked against unchunked forward (tests/test_lean_decoder.py:59)
CHUNK_REL = 1e-3   # chunked against unchunked gradients (tests/test_lean_decoder.py:72)
JAX_OUT = 5e-5     # the f32 sigmoid output against JAX, as the full decoder's test
F64_RTOL = 1e-9    # each gradient tensor in float64, relative to its largest entry

_SKIPS = [(1, 24, 3, 16, 16), (1, 48, 3, 16, 16), (1, 96, 3, 8, 8),
          (1, 192, 3, 4, 4), (1, 192, 8, 8, 8)]  # tests/test_lean_decoder.py:23-27


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def _cl(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _decoder(**kwargs):
    dec = DecoderFuse(**kwargs)
    g = torch.Generator().manual_seed(19)
    for m in dec.modules():
        if m is not dec and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return dec


def _run(dec, xs, dtype=torch.float32):
    """Output and the gradients of mean(out^2) under the port's names."""
    out = dec(*[torch.from_numpy(x).to(dtype) for x in xs])
    names = [f"decoder_fuse.{n}" for n, _ in dec.named_parameters()]
    grads = torch.autograd.grad((out * out).mean(), list(dec.parameters()))
    return out.detach().numpy(), {n: g.numpy() for n, g in zip(names, grads)}


# ---------------------------------------------------------------- remat


@pytest.mark.parametrize("form", ["pruned", "fused"])
def test_remat_is_bit_equal_and_reruns_the_chain_epilogues(form, monkeypatch):
    """``remat_convs`` on the pruned chain and on the full fused chain
    (``lean=False``): output and every gradient equal bit for bit to the
    same decoder without it, and the ReLU+InstanceNorm epilogue (K3's
    wrapper) called 27 times in the forward and 12 more in the backward,
    where the rematerialized chain stages run again."""
    kwargs = {"depth_mode": "pruned"} if form == "pruned" else {"lean": False}
    xs = [_normal(s, 40 + i) for i, s in enumerate(_SKIPS)]
    base = _decoder(**kwargs)
    remat = _decoder(remat_convs=True, **kwargs)
    calls = []
    epilogue = tconv.relu_instancenorm
    monkeypatch.setattr(tconv, "relu_instancenorm",
                        lambda y: calls.append(1) or epilogue(y))
    out0, g0 = _run(base, xs)
    assert len(calls) == 27
    calls.clear()
    out1, g1 = _run(remat, xs)
    assert len(calls) == 27 + 12
    np.testing.assert_array_equal(out0, out1)
    assert sorted(g0) == sorted(g1)
    for n in g0:
        np.testing.assert_array_equal(g0[n], g1[n], err_msg=n)


# ---------------------------------------------------------------- chunks


def _xla_epilogue(y):
    """K3's function with the JAX package's XLA statistics (single-pass),
    on channels-last ``y``."""
    ys, a, b = relu_in_stats(y.permute(0, 4, 1, 2, 3))
    return (ys * a + b).permute(0, 2, 3, 4, 1)


class _Float64Numpy:
    """numpy whose ``float32`` is ``float64``."""

    def __getattr__(self, name):
        return np.float64 if name == "float32" else getattr(np, name)


def _jax_chunked(dec, xs):
    """JAX's lean cascade with ``c2_chunks=8`` from the port's parameters:
    its output in f32."""
    from corrifnet_tpu.models.decoder import DecoderFuse as JaxDecoder

    sd = {f"decoder_fuse.{k}": v for k, v in dec.state_dict().items()}
    jm = JaxDecoder(depth_mode="full", lean=True, c2_chunks=8)
    fn = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, True))
    return np.asarray(fn(ti._decoder(sd), *[jnp.asarray(_cl(x)) for x in xs]))


def _jax_stage(kind, weight, bias, skip, handoff, cots, chunks, depth):
    """JAX's chunked ``LeanGeneralConv3d`` in float64 throughout: the output
    handoff and the gradients of ``sum(y * cy) + sum(a * ca) + sum(b * cb)``
    w.r.t. the inputs and parameters, in the port's layouts."""
    from corrifnet_tpu.nn.leandec import LeanGeneralConv3d as JaxLean
    from corrifnet_tpu.nn.leandec import LeanHandoff as JaxHandoff

    def cl(t):  # NCDHW -> channels-last, float64
        return jnp.asarray(np.moveaxis(np.asarray(t, np.float64), 1, -1))

    def nc(t):
        return np.moveaxis(np.asarray(t), -1, 1)

    k = 3 if kind == "nearest" else 1
    mod = JaxLean(weight.shape[0], k, 1, 1 if k == 3 else 0, pad_mode="replicate",
                  depth_chunks=chunks, dtype=jnp.float64)
    params = {"conv": {"kernel": jnp.asarray(np.asarray(weight, np.float64)
                                             .transpose(2, 3, 4, 1, 0)),
                       "bias": jnp.asarray(np.asarray(bias, np.float64))}}

    def loss(p, y, a, b, sk):
        h = JaxHandoff(y, a, b)
        x = (sk, h) if kind == "nearest" else h
        fuse = ("nearest", depth) if kind == "nearest" else None
        out = mod.apply({"params": p}, x, True, fuse)
        terms = [(o * cl(c)).sum() for o, c in zip(out, cots)]
        return terms[0] + terms[1] + terms[2], out

    args = [cl(t) for t in handoff] + [cl(skip) if skip is not None else None]
    grad = jax.grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)
    (gp, gy, ga, gb, gs), out = jax.jit(grad)(params, *args)
    grads = {"y": nc(gy), "a": nc(ga), "b": nc(gb),
             "weight": np.asarray(gp["conv"]["kernel"]).transpose(4, 3, 0, 1, 2),
             "bias": np.asarray(gp["conv"]["bias"])}
    if skip is not None:
        grads["skip"] = nc(gs)
    return [nc(o) for o in out], grads


@pytest.mark.parametrize("kind", ["nearest", "pointwise"])
def test_chunked_stage_matches_jax_in_float64(kind, monkeypatch):
    """One chunked lean stage, a skip-concat conv (a 3-row skip expanded to
    32 rows beside a 32-row handoff) and a 1x1 conv on a handoff, each in 4
    depth chunks, against JAX's ``LeanGeneralConv3d(depth_chunks=4)`` with
    the same parameters, both in float64: the output handoff ``(y, a, b)``
    and the gradients of the inputs, the weight and the bias under random
    cotangents, each within 1e-9 of its largest entry (the same function:
    JAX ``_chunked_nearest_conv`` / ``_chunked_pointwise_conv`` and
    ``_in_stats_of_act``, ``corrifnet_tpu/nn/leandec.py:113-225``)."""
    from corrifnet_tpu_torch.nn.leandec import LeanGeneralConv3d, LeanHandoff

    import corrifnet_tpu.nn.depthfuse as jdepthfuse
    import corrifnet_tpu.nn.resize as jresize

    depth, cs, cr, co = 32, 6, 5, 4
    k = 3 if kind == "nearest" else 1
    stage = LeanGeneralConv3d(cs * (kind == "nearest") + cr, co, k, 1, 1 if k == 3 else 0,
                              padding_mode="replicate", depth_chunks=4)
    stage.conv.reset_parameters(torch.Generator().manual_seed(21))
    stage.double()
    rng = np.random.default_rng(22)
    y = np.maximum(rng.normal(0.0, 1.0, (1, cr, depth, 8, 8)), 0.0)
    a = rng.uniform(0.5, 1.5, (1, cr, 1, 1, 1))
    b = rng.normal(0.0, 1.0, (1, cr, 1, 1, 1))
    skip = rng.normal(0.0, 1.0, (1, cs, 3, 8, 8)) if kind == "nearest" else None
    cots = [rng.normal(0.0, 1.0, (1, co, depth, 8, 8)), rng.normal(0.0, 1.0, (1, co, 1, 1, 1)),
            rng.normal(0.0, 1.0, (1, co, 1, 1, 1))]

    leaves = {"y": y, "a": a, "b": b}
    if skip is not None:
        leaves["skip"] = skip
    ts = {n: torch.from_numpy(v).requires_grad_() for n, v in leaves.items()}
    h = LeanHandoff(ts["y"], ts["a"], ts["b"])
    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, "float", lambda self, *a_, **k_: self.double())
        if kind == "nearest":
            out = stage((ts["skip"], h), ("nearest", depth))
        else:
            out = stage(h)
        total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots))
        params = {"weight": stage.conv.weight, "bias": stage.conv.bias}
        grads = torch.autograd.grad(total, [*ts.values(), *params.values()])
    got = dict(zip([*ts, *params], (g.numpy() for g in grads)))

    with jax.enable_x64(True), monkeypatch.context() as patch:
        patch.setattr(jnp, "float32", jnp.float64)
        patch.setattr(jresize, "np", _Float64Numpy())
        patch.setattr(jdepthfuse, "tap_expand_table", jdepthfuse.tap_expand_table.__wrapped__)
        want_out, want = _jax_stage(kind, stage.conv.weight.detach().numpy(),
                                    stage.conv.bias.detach().numpy(), skip,
                                    (y, a, b), cots, 4, depth)
    for o, w in zip(out, want_out):
        assert _rel(o.detach().numpy(), w) <= F64_RTOL
    assert sorted(got) == sorted(want)
    worst = max((_rel(got[n], want[n]), n) for n in want)
    assert worst[0] <= F64_RTOL, worst


def test_decoder_chunk_matches_unchunked_and_jax(monkeypatch):
    """The lean cascade with ``c2_chunks=8`` (``d2_c2`` in 4 chunks of 16
    rows, ``d1_c2`` and ``d1_out`` in 8 of 16), the RFM blocks ending in the
    JAX package's XLA epilogue, against the unchunked lean cascade with the
    same parameters: in f32 the output within 2e-6 (the JAX package's bound
    for this pair), and every gradient tensor within 1e-3 of its largest
    entry of the unchunked cascade's in float64, or within twice the
    unchunked cascade's own f32 distance from it where that is larger (a
    conv bias before ReLU+InstanceNorm gets a gradient that nearly cancels).
    Against JAX's chunked cascade the f32 output within 5e-5 (its stages
    are held in float64 by ``test_chunked_stage_matches_jax_in_float64``)."""
    xs = [_normal(s, 50 + i) for i, s in enumerate(_SKIPS)]
    chunked = _decoder(lean=True, c2_chunks=8)
    plain = _decoder(lean=True)
    assert [chunked._lean[n].depth_chunks for n in ("d2_c2", "d1_c2", "d1_out")] == [4, 8, 8]
    assert sum(stage.depth_chunks for stage in chunked._lean.values()) == 20
    monkeypatch.setattr(tconv, "relu_instancenorm", _xla_epilogue)

    out, got = _run(chunked, xs)
    out0, got0 = _run(plain, xs)
    assert np.abs(out - out0).max() <= CHUNK_OUT
    want = _jax_chunked(chunked, xs)
    assert out.shape == want.shape == (1, 3, 1, 224, 224)
    assert np.abs(out - want).max() <= JAX_OUT

    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
        _, got064 = _run(plain.double(), xs, torch.float64)
    worst = max((_rel(got[n], got064[n]) / max(CHUNK_REL, 2 * _rel(got0[n], got064[n])), n)
                for n in got064)
    assert worst[0] <= 1.0, worst
