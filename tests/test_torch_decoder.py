"""The port's default decoder against the JAX package, on the CPU in f32.

* ``tap_expand_table`` equal to JAX's element for element, and the port's
  nearest resize on the tables' rows;
* ``fused_resize_conv`` and the depth-fused ``Conv`` (``linear`` and
  ``nearest``) against JAX's and against the port's own resize-then-conv,
  forward and gradients;
* ``relu_in_stats`` against JAX's, forward and custom backward, at the
  ReLU's zeros too;
* one lean stage per input form against JAX's ``LeanGeneralConv3d``, and the
  conv's forward not run again in its backward;
* the whole cascade (the small skips of ``tests/test_lean_decoder.py`` at
  B=1): lean against the standard fused chain, and against JAX;
* ``check_supported`` and the model builder honour ``decoder_lean``.

Inputs are made from a numpy seed and fed to both sides. The port is NCDHW,
the JAX package channels-last. Each test states its tolerance.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import jax_import
from corrifnet_tpu_torch.models.decoder import DecoderFuse
from corrifnet_tpu_torch.nn import Conv, GeneralConv3d, conv as tconv, resize_linear, resize_nearest
from corrifnet_tpu_torch.nn import depthfuse
from corrifnet_tpu_torch.nn.leandec import LeanGeneralConv3d, LeanHandoff, relu_in_stats
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

FUSE_REL = 1e-6  # depth fusion: f32 reassociation (nn/depthfuse.py:21-23)
LEAN_REL = 2e-5  # lean against standard gradients (tests/test_lean_decoder.py:67)


def _normal(shape, seed, scale=1.0, shift=0.0):
    return np.random.default_rng(seed).normal(shift, scale, shape).astype(np.float32)


def _cl(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def _ncdhw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _conv(cin, cout, k, mode, seed):
    c = Conv(cin, cout, k, 1, 1 if k == 3 else 0, padding_mode=mode)
    c.reset_parameters(torch.Generator().manual_seed(seed))
    return c


def _jax_conv_params(c):
    return {"kernel": jnp.asarray(c.weight.detach().permute(2, 3, 4, 1, 0).numpy()),
            "bias": jnp.asarray(c.bias.detach().numpy())}


def _grads(fn, arrays, cotangent):
    """Output and gradients of ``sum(fn(*arrays) * cotangent)`` w.r.t. arrays
    and the parameters ``fn`` closes over (given as ``arrays``' tail)."""
    leaves = [torch.from_numpy(a).requires_grad_() if isinstance(a, np.ndarray) else a
              for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(cotangent)).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("kind", ["linear", "nearest"])
@pytest.mark.parametrize("pad_mode", ["replicate", "zeros"])
def test_tap_expand_table_equals_jax(kind, pad_mode):
    """Every table the decoder uses, element for element (the port builds
    them in float64 and casts where it uses them; JAX's are float32)."""
    from corrifnet_tpu.nn.depthfuse import tap_expand_table as jax_table

    pairs = ([(8, 16), (16, 32), (32, 64), (64, 128)] if kind == "linear"
             else [(3, 16), (3, 32), (3, 64), (3, 128)])
    for src, dst in pairs:
        got = depthfuse.tap_expand_table(kind, src, dst, pad_mode)
        assert got.dtype == np.float64 and got.shape == (dst, 3, src)
        np.testing.assert_array_equal(got.astype(np.float32),
                                      jax_table(kind, src, dst, pad_mode))


def test_nearest_tables_are_the_port_resize_rows():
    """PyTorch's nearest resize (float32 index rule) and the tables' float64
    rule pick the same source row for 3 -> 16, 32, 64, 128."""
    x = torch.arange(3.0).view(1, 1, 3, 1, 1)
    for dst in (16, 32, 64, 128):
        rows = resize_nearest(x, (dst, 1, 1)).flatten().long().numpy()
        table = depthfuse.tap_expand_table("nearest", 3, dst)[:, 1, :]
        np.testing.assert_array_equal(table.argmax(1), rows)


# ---------------------------------------------------------------- fused conv


@pytest.mark.parametrize("kind", ["linear", "nearest"])
@pytest.mark.parametrize("pad_mode", ["replicate", "zeros"])
def test_fused_conv_matches_jax_and_resize_then_conv(kind, pad_mode):
    """``Conv(x, depth_fuse)`` (and, for ``linear``, ``fused_resize_conv``
    itself) against JAX's ``Conv.__call__(x, depth_fuse)`` and against the
    port's resize-then-conv: output and the gradients of input(s), weight and
    bias under a random cotangent: every entry within 1e-6 of the sum of the
    magnitudes of the products it sums (f32 reassociation; the port's resize
    runs in f32)."""
    from corrifnet_tpu.nn.conv import Conv as JaxConv
    from corrifnet_tpu.nn.depthfuse import fused_resize_conv as jax_fused

    dst, h, w = 16, 10, 11
    if kind == "linear":
        c = _conv(6, 4, 3, pad_mode, 1)
        xs = [_normal((2, 6, 8, h, w), 2)]
        fused = lambda z, wt, b: c(z, ("linear", dst))  # noqa: E731
        naive = lambda z, wt, b: c(resize_linear(z, (dst, h, w)))  # noqa: E731
    else:
        c = _conv(5 + 7, 4, 3, pad_mode, 3)
        xs = [_normal((2, 5, 3, h, w), 4), _normal((2, 7, dst, h, w), 5)]
        fused = lambda s, r, wt, b: c((s, r), ("nearest", dst))  # noqa: E731
        naive = lambda s, r, wt, b: c(torch.cat(  # noqa: E731
            [resize_nearest(s, (dst, h, w)), r], 1))
    g = _normal((2, 4, dst, h, w), 6)
    params = [c.weight, c.bias]
    state = {k: v.clone() for k, v in c.state_dict().items()}
    out, grads = _grads(fused, xs + params, g)
    out_n, grads_n = _grads(naive, xs + params, g)
    # each entry is a sum of products; its reassociation error is measured
    # against the same sum of the products' magnitudes (the plain chain on
    # |inputs|, |parameters| and |cotangent|)
    with torch.no_grad():
        for p_ in params:
            p_.abs_()
    scale, scales = _grads(naive, [np.abs(x) for x in xs] + params, np.abs(g))
    with torch.no_grad():
        c.load_state_dict(state)

    def within(got, want, mag):
        return bool((np.abs(np.asarray(got) - np.asarray(want)) <= FUSE_REL * mag).all())

    assert out.shape == (2, 4, dst, h, w)
    assert within(out, out_n, scale)
    assert all(within(a, b, m) for a, b, m in zip(grads, grads_n, scales))

    jm = JaxConv(4, (3, 3, 3), 1, (1, 1, 1), pad_mode=pad_mode)
    p = {"params": _jax_conv_params(c)}
    jx = [jnp.asarray(_cl(x)) for x in xs]

    def jfn(p, *parts):
        x = parts[0] if kind == "linear" else tuple(parts)
        return jm.apply(p, x, depth_fuse=(kind, dst))

    want, vjp = jax.vjp(jfn, p, *jx)
    gp, *gx = vjp(jnp.asarray(_cl(g)))
    assert within(out, _ncdhw(want), scale)
    for got_x, want_x, mag in zip(grads, gx, scales):
        assert within(got_x, _ncdhw(want_x), mag)
    kernel = np.asarray(gp["params"]["kernel"]).transpose(4, 3, 0, 1, 2)
    assert within(grads[len(xs)], kernel, scales[len(xs)])
    assert within(grads[-1], gp["params"]["bias"], scales[-1])

    if kind == "linear":  # the function under the Conv, without the bias
        with torch.no_grad():
            y = depthfuse.fused_resize_conv(torch.from_numpy(xs[0]), c.weight, dst,
                                            "linear", pad_mode, (1, 1, 1))
        pd = ((1, 1), (1, 1), (1, 1))
        want_f = jax_fused(jx[0], p["params"]["kernel"], dst, "linear", pad_mode, pd,
                           jnp.float32)
        assert y.is_contiguous(memory_format=torch.channels_last_3d)
        assert within(y.numpy(), _ncdhw(want_f), scale)


# ---------------------------------------------------------------- relu_in_stats


@pytest.mark.parametrize("zeros", [False, True])
def test_relu_in_stats_matches_jax(zeros):
    """Forward (y, a, b) within 1e-6 of JAX's; the gradient through the
    consumer's fma, ``sum((y a + b) g)``, against JAX's custom VJP within
    1e-5 of its largest entry. ``zeros``: a quarter of the inputs exactly 0,
    where the ReLU's gradient is 0 (tests/test_lean_decoder.py:127)."""
    from corrifnet_tpu.ops.instancenorm import relu_in_stats as jax_ris

    x = _normal((2, 6, 4, 8, 8), 7)
    if zeros:
        x[:, :, ::2, ::2] = 0.0
    g = _normal(x.shape, 8)

    def port(t):
        y, a, b = relu_in_stats(t)
        return y * a + b

    xt = torch.from_numpy(x).requires_grad_()
    y, a, b = relu_in_stats(xt)
    (dx,) = torch.autograd.grad((port(xt) * torch.from_numpy(g)).sum(), xt)

    jy, ja, jb = jax_ris(jnp.asarray(_cl(x)))
    assert _rel(y.detach().numpy(), _ncdhw(jy)) <= 1e-6
    assert _rel(a.detach().numpy().reshape(2, 6), np.asarray(ja).reshape(2, 6)) <= 1e-6
    assert _rel(b.detach().numpy().reshape(2, 6), np.asarray(jb).reshape(2, 6)) <= 1e-6
    _, vjp = jax.vjp(lambda t: (lambda r: r[0] * r[1] + r[2])(jax_ris(t)),
                     jnp.asarray(_cl(x)))
    (want,) = vjp(jnp.asarray(_cl(g)))
    assert _rel(dx.numpy(), _ncdhw(want)) <= 1e-5
    if zeros:
        assert not dx.numpy()[x <= 0].any()


# ---------------------------------------------------------------- lean stages


_STAGES = {
    # name: (cin, cout, k, input form, depth_fuse, pre_resize)
    "linear_pre_resize": (6, 4, 3, "handoff", ("linear", 16), (8, 12, 12)),
    "nearest_skip_pair": (5 + 6, 4, 3, "pair", ("nearest", 16), ()),
    "pointwise": (6, 4, 1, "handoff", None, ()),
}


@pytest.mark.parametrize("case", sorted(_STAGES))
def test_lean_stage_matches_jax(case, monkeypatch):
    """``LeanGeneralConv3d`` against JAX's, from the same handoff (and skip):
    the output handoff within 1e-5 (y) and 1e-4 (a, b: rsqrt of a variance)
    of the largest entry, the gradients of y, a, b, skip, weight and bias
    under a random cotangent of the next fma within 1e-4. In the backward
    the conv's input is rebuilt once and no convolution runs forward again."""
    from corrifnet_tpu.nn.leandec import LeanGeneralConv3d as JaxLean
    from corrifnet_tpu.nn.leandec import LeanHandoff as JaxHandoff

    cin, cout, k, form, fuse, pre = _STAGES[case]
    run_c = 6
    hw = 12 if pre else 8
    src_hw = 6 if pre else hw
    d_in = 8 if fuse and fuse[0] == "linear" else 16
    stage = LeanGeneralConv3d(cin, cout, k, 1, 1 if k == 3 else 0, "replicate", pre)
    stage.conv.reset_parameters(torch.Generator().manual_seed(9))
    y_in = np.maximum(_normal((1, run_c, d_in, src_hw, src_hw), 10), 0)
    a_in = np.abs(_normal((1, run_c, 1, 1, 1), 11)) + 0.5
    b_in = _normal((1, run_c, 1, 1, 1), 12)
    skip = _normal((1, cin - run_c, 3, hw, hw), 13)
    d_out = fuse[1] if fuse else d_in
    g = _normal((1, cout, d_out, hw, hw), 14)

    calls = {"prepare": 0, "conv": 0}
    prepare = stage._prepare

    def counted_prepare(*args):
        calls["prepare"] += 1
        return prepare(*args)

    for name in ("conv2d", "conv3d"):
        fn = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _fn=fn, **kw: (
            calls.__setitem__("conv", calls["conv"] + 1), _fn(*a, **kw))[1])
    monkeypatch.setattr(stage, "_prepare", counted_prepare)

    pair = form == "pair"
    leaves = [torch.from_numpy(v).requires_grad_() for v in (y_in, a_in, b_in, skip)]
    h = LeanHandoff(*leaves[:3])
    out = stage((leaves[3], h) if pair else h, fuse)
    leaves = leaves[:3 + pair]
    assert calls == {"prepare": 1, "conv": 1 + pair}
    normed = out.y * out.a + out.b
    params = [stage.conv.weight, stage.conv.bias]
    grads = torch.autograd.grad((normed * torch.from_numpy(g)).sum(), leaves + params)
    assert calls == {"prepare": 2, "conv": 1 + pair}

    jm = JaxLean(cout, k, 1, 1 if k == 3 else 0, pad_mode="replicate", pre_resize=pre)
    p = {"params": {"conv": _jax_conv_params(stage.conv)}}

    def jfn(p, y, a, b, s):
        hh = JaxHandoff(y, a, b)
        o = jm.apply(p, (s, hh) if pair else hh, True, fuse)
        return o.y * o.a + o.b, o

    jin = [jnp.asarray(_cl(v)) for v in (y_in, a_in, b_in, skip)]
    (want, wo), vjp = jax.vjp(lambda *t: jfn(*t), p, *jin)
    assert _rel(out.y.detach().numpy(), _ncdhw(wo.y)) <= 1e-5
    for got_s, want_s in ((out.a, wo.a), (out.b, wo.b)):
        assert _rel(got_s.detach().numpy().reshape(-1), np.asarray(want_s).reshape(-1)) <= 1e-4
    gp, *gx = vjp((jnp.asarray(_cl(g)), jax.tree.map(jnp.zeros_like, wo)))
    for i in range(len(leaves)):
        assert _rel(grads[i].numpy(), _ncdhw(gx[i])) <= 1e-4, i
    gw, gb = grads[len(leaves):]
    assert _rel(gw.numpy(),
                np.asarray(gp["params"]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2)) <= 1e-4
    assert _rel(gb.numpy(), gp["params"]["conv"]["bias"]) <= 1e-4


# ---------------------------------------------------------------- the cascade

_SKIPS = [(1, 24, 3, 16, 16), (1, 48, 3, 16, 16), (1, 96, 3, 8, 8),
          (1, 192, 3, 4, 4), (1, 192, 8, 8, 8)]  # tests/test_lean_decoder.py:23-27


def _xla_epilogue(y):
    """K3's function with the JAX package's XLA statistics (single-pass),
    on channels-last ``y``: the standard stage's epilogue in JAX on the CPU."""
    ys, a, b = relu_in_stats(y.permute(0, 4, 1, 2, 3))
    return (ys * a + b).permute(0, 2, 3, 4, 1)


@pytest.fixture(scope="module")
def cascade():
    """The port's fused decoder with and without lean, and JAX's fused lean
    decoder with the XLA epilogue, from the same parameters and skips:
    outputs and the gradients of mean(out^2), under the port's names."""
    from corrifnet_tpu.models.decoder import DecoderFuse as JaxDecoder

    xs = [_normal(s, 20 + i) for i, s in enumerate(_SKIPS)]
    std = DecoderFuse(lean=False)
    g = torch.Generator().manual_seed(15)
    for m in std.modules():
        if m is not std and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    lean = DecoderFuse(lean=True)
    lean.load_state_dict(std.state_dict())
    got = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(tconv, "relu_instancenorm", _xla_epilogue)
    try:
        for name, dec in (("std", std), ("lean", lean)):
            out = dec(*map(torch.from_numpy, xs))
            names = [n for n, _ in dec.named_parameters()]
            grads = torch.autograd.grad((out * out).mean(), list(dec.parameters()))
            got[name] = (out.detach().numpy(),
                         {f"decoder_fuse.{n}": gr.numpy() for n, gr in zip(names, grads)})
    finally:
        mp.undo()

    jm = JaxDecoder(depth_mode="full", lean=True)
    sd = {f"decoder_fuse.{k}": v for k, v in std.state_dict().items()}
    params = ti._decoder(sd)
    jxs = [jnp.asarray(_cl(x)) for x in xs]

    def loss(p):
        out = jm.apply({"params": p}, *jxs, True)
        return (out * out).mean(), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    named = {}
    jax_import._decoder(named, jax.tree.map(np.asarray, jgrads))
    got["jax"] = (np.asarray(want), {k: v.numpy() for k, v in named.items()})
    return got


def test_lean_decoder_matches_standard_and_jax(cascade):
    """Lean against the standard fused chain, both with the JAX package's
    XLA epilogue (the standard path K3 runs on the CPU computes its variance
    in two passes, ``relu_in_stats`` in one, as in JAX): the same output,
    and every gradient tensor within 2e-5 of its largest entry (JAX:
    tests/test_lean_decoder.py:62-67). Against JAX's fused lean decoder with
    the same parameters: output within 5e-5, gradients to the whole-step
    test's bounds (``torch_train_step.check_train_step``: cosine of the whole
    gradient >= 0.97, each tensor within 0.4 of its norm, the head's bias
    within 2e-4 of its largest entry)."""
    out_s, g_s = cascade["std"]
    out_l, g_l = cascade["lean"]
    out_j, g_j = cascade["jax"]
    assert out_l.shape == out_j.shape == (1, 3, 1, 224, 224)
    assert np.abs(out_l - out_s).max() <= 1e-6
    assert sorted(g_l) == sorted(g_s) == sorted(g_j)
    worst = max(_rel(g_l[n], g_s[n]) for n in g_s)
    assert worst <= LEAN_REL, worst

    assert np.abs(out_l - out_j).max() <= 5e-5
    dot = sum(float((g_l[n] * g_j[n]).sum()) for n in g_j)
    norms = math.sqrt(sum(float((g_l[n] ** 2).sum()) for n in g_j)
                      * sum(float((g_j[n] ** 2).sum()) for n in g_j))
    assert dot / norms >= 0.97
    assert max(float(np.linalg.norm(g_l[n] - g_j[n]) / np.linalg.norm(g_j[n]))
               for n in g_j) <= 0.4
    head = "decoder_fuse.final_conv.bias"
    assert _rel(g_l[head], g_j[head]) <= 2e-4


def test_decoder_batch_rule_and_shared_parameters():
    """``lean=None`` takes the lean cascade at batch <= 4 and the standard
    fused chain above (JAX ``decoder.py:107``); the lean stages run on the
    standard stages' parameter tensors, and the state_dict is the same for
    every setting."""
    dec = DecoderFuse()
    assert dec._uses_lean(4) and not dec._uses_lean(5)
    assert not DecoderFuse(lean=False)._uses_lean(1)
    assert DecoderFuse(lean=True)._uses_lean(8)
    assert not DecoderFuse(fuse_depth=False)._uses_lean(1)
    assert all(dec._lean[n].conv is getattr(dec, n).conv for n in dec._lean)
    assert len(dec._lean) == 12
    keys = sorted(dec.state_dict())
    for kwargs in ({"lean": False}, {"lean": True}, {"fuse_depth": False}):
        assert sorted(DecoderFuse(**kwargs).state_dict()) == keys
    assert isinstance(dec.d1_c2, GeneralConv3d)


# ---------------------------------------------------------------- configuration


@pytest.mark.parametrize("lean", [True, False, None])
def test_check_supported_honours_decoder_lean(lean):
    from corrifnet_tpu_torch.config import ExperimentConfig, check_supported

    check_supported(ExperimentConfig(decoder_lean=lean), "cuda")


def test_create_model_passes_decoder_lean_to_the_decoder():
    from corrifnet_tpu_torch.models import create_model

    model = create_model("MMVit4", decoder_lean=True)
    assert model.decoder_fuse.lean is True and model.decoder_fuse.fuse_depth


@pytest.mark.parametrize("field,value", [("decoder_chunk", 2), ("decoder_remat", True),
                                         ("depth_mode", "pruned")])
def test_check_supported_still_refuses_the_decoder_levers(field, value):
    """The decoder's three levers, refused before they were ported, are
    taken by ``check_supported`` and reach MMVit4's decoder through the
    registry (built on the meta device)."""
    from corrifnet_tpu_torch.config import ExperimentConfig, check_supported
    from corrifnet_tpu_torch.run.profile import meta_model

    check_supported(ExperimentConfig(**{field: value}), "cuda")
    dec = meta_model("MMVit4", **{field: value}).decoder_fuse
    got = {"decoder_chunk": dec.c2_chunks, "decoder_remat": dec.remat_convs,
           "depth_mode": "pruned" if dec.pruned else "full"}[field]
    assert got == value


@pytest.mark.parametrize("entry", ["main", "evaluate"])
def test_entry_points_pass_decoder_lean_to_the_model(entry, tmp_path, monkeypatch):
    """Both entry points build the model with ``cfg.decoder_lean`` (the run
    stops there)."""
    import json

    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import evaluate, main

    class Built(Exception):
        pass

    def create(name, **kwargs):
        raise Built(kwargs)

    mod = main if entry == "main" else evaluate
    monkeypatch.setattr(mod, "create_model", create)
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "dtype": "float32",
         "decoder_lean": True}))
    with pytest.raises(Built) as built:
        mod.main(["--config", "cfg.json", "--device", "cpu"])
    assert built.value.args[0]["decoder_lean"] is True
