"""The port's layers and metrics against the JAX package.

Each port module runs with weights from a fixed seed; its ``state_dict`` is
converted with the JAX package's own reference-layout converters
(``corrifnet_tpu.models.torch_import``) and the JAX module runs the same
numpy inputs, in f32 on the CPU. Layouts: the port is NCDHW, the JAX
package channels-last.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch import nn as tnn
from corrifnet_tpu_torch.models.decoder import DecoderFuse
from corrifnet_tpu_torch.models.resnet3d import Bottleneck3D
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# f32 bounds: convolutions, matmuls and reductions summed in another order
CONV_ATOL = 2e-5
NORM_ATOL = 1e-5


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _init(module, seed=0):
    g = _gen(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return module.eval()


def _sd(module, prefix):
    return {f"{prefix}.{k}": v for k, v in module.state_dict().items()}


def _normal(shape, seed, scale=1.0, shift=0.0):
    return np.random.default_rng(seed).normal(shift, scale, shape).astype(np.float32)


def _cl(x):
    """NCDHW numpy -> channels-last."""
    return np.moveaxis(x, 1, -1)


def _run_torch(module, *xs):
    with torch.no_grad():
        out = module(*(torch.from_numpy(x) for x in xs))
    return out.numpy()


def _run_jax(module, variables, *xs, **kw):
    return np.asarray(module.apply(variables, *(jnp.asarray(x) for x in xs), **kw))


def _random_bn_stats(module, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tnn.BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))


# ---------------------------------------------------------------- conv


_CONV_CASES = {
    # name: (cin, cout, kernel, stride, padding, padding_mode, input shape)
    "decoder_replicate_3": (4, 6, 3, 1, 1, "replicate", (2, 4, 5, 6, 7)),
    "decoder_replicate_1": (6, 5, 1, 1, 0, "replicate", (2, 6, 4, 4, 4)),
    "rfm_zeros_3": (5, 5, 3, 1, 1, "zeros", (1, 5, 3, 6, 6)),
    "stem": (1, 8, (3, 7, 7), (1, 2, 2), (1, 3, 3), "zeros", (2, 1, 3, 16, 16)),
    "bottleneck_conv2": (4, 4, (1, 3, 3), (1, 2, 2), (0, 1, 1), "zeros",
                         (2, 4, 3, 8, 8)),
}


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_conv_matches_jax(case):
    from corrifnet_tpu.nn import Conv as JConv

    cin, cout, k, s, p, mode, shape = _CONV_CASES[case]
    conv = _init(tnn.Conv(cin, cout, k, s, p, padding_mode=mode), seed=1)
    x = _normal(shape, 2)
    got = _run_torch(conv, x)
    jm = JConv(cout, k, s, p, pad_mode=mode)
    want = _run_jax(jm, {"params": ti._conv(_sd(conv, "c"), "c")}, _cl(x))
    np.testing.assert_allclose(_cl(got), want, atol=CONV_ATOL, rtol=0)


def test_conv_pointwise_matches_jax_dense():
    from corrifnet_tpu.nn import Dense as JDense

    conv = _init(tnn.Conv(64, 96, 1), seed=3)
    tokens = _normal((2, 512, 64), 4)
    with torch.no_grad():
        got = conv.pointwise(torch.from_numpy(tokens)).numpy()
    want = _run_jax(JDense(96), {"params": ti._dense(_sd(conv, "c"), "c")}, tokens)
    np.testing.assert_allclose(got, want, atol=CONV_ATOL, rtol=0)


def test_dense_matches_jax():
    from corrifnet_tpu.nn import Dense as JDense

    dense = _init(tnn.Dense(48, 32), seed=5)
    x = _normal((3, 7, 48), 6)
    sd = dense.state_dict()
    params = {"kernel": sd["weight"].numpy().T, "bias": sd["bias"].numpy()}
    want = _run_jax(JDense(32), {"params": params}, x)
    np.testing.assert_allclose(_run_torch(dense, x), want, atol=CONV_ATOL, rtol=0)


def test_general_conv3d_matches_jax():
    from corrifnet_tpu.nn import GeneralConv3d as JGC

    gc = _init(tnn.GeneralConv3d(6, 8, 3, 1, 1, padding_mode="replicate"), seed=7)
    x = _normal((2, 6, 4, 8, 8), 8)
    jm = JGC(8, 3, 1, 1, pad_mode="replicate", use_pallas_epilogue=True)
    want = _run_jax(jm, {"params": ti._general_conv(_sd(gc, "g"), "g")}, _cl(x))
    np.testing.assert_allclose(_cl(_run_torch(gc, x)), want, atol=NORM_ATOL, rtol=0)


def test_fusion_prenorm_matches_jax():
    from corrifnet_tpu.nn import FusionPrenorm as JFP

    fp = _init(tnn.FusionPrenorm(12), seed=9)
    x = _normal((2, 12, 3, 8, 8), 10)
    jm = JFP(12, use_pallas_epilogue=True)
    want = _run_jax(jm, {"params": ti._fusion_prenorm(_sd(fp, "r"), "r")}, _cl(x),
                    train=False)
    np.testing.assert_allclose(_cl(_run_torch(fp, x)), want, atol=NORM_ATOL, rtol=0)


def test_early_fusion_block_matches_jax():
    from corrifnet_tpu.nn import EarlyFusionBlock as JEF

    ef = _init(tnn.EarlyFusionBlock(3 * 8), seed=11)
    xs = [_normal((2, 8, 3, 6, 6), 12 + i) for i in range(3)]
    want = _run_jax(JEF(), {"params": {"conv": ti._conv(_sd(ef, "f"), "f.conv")}},
                    *(_cl(x) for x in xs))
    np.testing.assert_allclose(_cl(_run_torch(ef, *xs)), want, atol=NORM_ATOL, rtol=0)


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize("src,dst", [
    ((3, 14, 14), (8, 8, 8)),       # x6 pyramid
    ((8, 8, 8), (16, 16, 16)),      # decoder up2
    ((1, 16, 16), (1, 28, 28)),     # up_to_224 on depth slice 0
])
def test_resize_linear_matches_jax(src, dst):
    from corrifnet_tpu.nn.resize import resize_linear as jr

    x = _normal((2, 3, *src), 14)
    got = tnn.resize_linear(torch.from_numpy(x), dst).numpy()
    want = np.asarray(jr(jnp.asarray(_cl(x)), dst, align_corners=True))
    # PyTorch derives the source coordinates in f32, the JAX package's
    # interpolation matrices in f64: a few f32 ulps of the O(1) values
    np.testing.assert_allclose(_cl(got), want, atol=NORM_ATOL, rtol=0)


@pytest.mark.parametrize("src,dst", [
    ((3, 14, 14), (16, 16, 16)), ((3, 28, 28), (32, 32, 32)),
    ((3, 56, 56), (64, 64, 64)), ((3, 56, 56), (128, 128, 128)),
])
def test_resize_nearest_matches_jax(src, dst):
    from corrifnet_tpu.nn.resize import resize_nearest as jr

    x = _normal((1, 2, *src), 15)
    got = tnn.resize_nearest(torch.from_numpy(x), dst).numpy()
    want = np.asarray(jr(jnp.asarray(_cl(x)), dst))
    np.testing.assert_array_equal(_cl(got), want)


@pytest.mark.parametrize("src,dst", [
    ((3, 14, 14), (16, 16, 16)), ((3, 28, 28), (32, 32, 32)),
    ((3, 56, 56), (64, 64, 64)), ((3, 56, 56), (128, 128, 128)),
    ((8, 8, 8), (4, 8, 5)),
])
def test_resize_nearest_gradient_matches_jax(src, dst):
    """The port computes this backward itself (one one-hot product per
    axis): each source voxel gets the sum of the gradients of its copies.
    Against jax.grad of the JAX function and against PyTorch's own backward
    on the CPU, f32, 1e-5 of the largest gradient (sums of up to 120
    terms in another order)."""
    import torch.nn.functional as F
    from corrifnet_tpu.nn.resize import resize_nearest as jr

    x = _normal((1, 2, *src), 17)
    g = _normal((1, 2, *dst), 18)
    leaf = torch.from_numpy(x).requires_grad_()
    got, = torch.autograd.grad(tnn.resize_nearest(leaf, dst), leaf, torch.from_numpy(g))
    want = jax.grad(lambda a: (jr(a, dst) * jnp.asarray(_cl(g))).sum())(jnp.asarray(_cl(x)))
    atol = 1e-5 * float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(_cl(got.numpy()), np.asarray(want), atol=atol, rtol=0)
    own, = torch.autograd.grad(F.interpolate(leaf, size=dst), leaf, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), own.numpy(), atol=atol, rtol=0)


def test_max_pool_matches_jax():
    from corrifnet_tpu.nn.resize import max_pool as jp

    x = _normal((2, 4, 3, 9, 10), 16)
    got = tnn.max_pool(torch.from_numpy(x), (1, 3, 3), (1, 2, 2), (0, 1, 1)).numpy()
    want = np.asarray(jp(jnp.asarray(_cl(x)), (1, 3, 3), (1, 2, 2), (0, 1, 1)))
    np.testing.assert_array_equal(_cl(got), want)


# ---------------------------------------------------------------- norms


def test_batchnorm_eval_matches_jax():
    from corrifnet_tpu.nn import BatchNorm as JBN

    bn = tnn.BatchNorm(6).eval()  # train mode is tests/test_torch_train.py's
    _random_bn_stats(bn, 17)
    x = _normal((2, 6, 3, 5, 5), 18)
    p, s = ti._bn(_sd(bn, "b"), "b")
    want = _run_jax(JBN(), {"params": p, "batch_stats": s}, _cl(x),
                    use_running_average=True)
    np.testing.assert_allclose(_cl(_run_torch(bn, x)), want, atol=1e-6, rtol=0)


def test_instancenorm_matches_jax():
    from corrifnet_tpu.nn import InstanceNorm as JIN

    x = _normal((2, 5, 3, 6, 6), 19, shift=0.5)
    want = _run_jax(JIN(), {}, _cl(x))
    np.testing.assert_allclose(_cl(_run_torch(tnn.InstanceNorm(), x)), want,
                               atol=NORM_ATOL, rtol=0)


def test_layernorm_matches_jax():
    from corrifnet_tpu.nn import LayerNorm as JLN

    ln = tnn.LayerNorm(32)
    rng = np.random.default_rng(20)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(rng.normal(1, 0.1, 32).astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 32).astype(np.float32)))
    x = _normal((2, 7, 32), 21, scale=2.0, shift=0.5)
    params = {"scale": ln.weight.detach().numpy(), "bias": ln.bias.detach().numpy()}
    want = _run_jax(JLN(), {"params": params}, x)
    np.testing.assert_allclose(_run_torch(ln, x), want, atol=NORM_ATOL, rtol=0)


# ---------------------------------------------------------------- blocks


def test_transformer_matches_jax():
    from corrifnet_tpu.nn import Transformer as JT

    tr = _init(tnn.Transformer(512, 1, 8, 512), seed=22)
    x = _normal((2, 64, 512), 23)
    pos = _normal((1, 64, 512), 24, scale=0.1)
    params = ti._transformer(_sd(tr, "t"), "t")
    jm = JT(512, depth=1, heads=8, mlp_dim=512, use_pallas_attn=True)
    want = _run_jax(jm, {"params": params}, x, pos)
    np.testing.assert_allclose(_run_torch(tr, x, pos), want, atol=CONV_ATOL, rtol=0)


def test_self_attention_hands_the_projection_over_without_copies(monkeypatch):
    """SelfAttention gives the attention entry point the qkv projection's
    output itself, as its (B, N, 3, H, D) view: no permuted copy of q, k or v
    is made on the way in."""
    from corrifnet_tpu_torch.nn import transformer

    seen = []
    real = transformer.fused_attention_qkv

    def spy(qkv, *args, **kwargs):
        seen.append(qkv)
        return real(qkv, *args, **kwargs)

    monkeypatch.setattr(transformer, "fused_attention_qkv", spy)
    attn = _init(transformer.SelfAttention(128, heads=2), seed=30)
    projected = []
    attn.qkv.register_forward_hook(lambda mod, args, out: projected.append(out))
    x = torch.from_numpy(_normal((2, 64, 128), 31))
    out = attn(x)
    assert out.shape == (2, 64, 128)
    (qkv,), (lin,) = seen, projected
    assert qkv.shape == (2, 64, 3, 2, 64) and qkv.is_contiguous()
    assert qkv.data_ptr() == lin.data_ptr()


@pytest.mark.parametrize("stride,has_down", [(1, True), (2, True), (1, False)])
def test_bottleneck3d_matches_jax(stride, has_down):
    from corrifnet_tpu.models.resnet3d import Bottleneck3D as JB

    cin = 32 if has_down else 64
    blk = _init(Bottleneck3D(cin, 16, stride, has_down), seed=25)
    _random_bn_stats(blk, 26)
    x = _normal((2, cin, 3, 8, 8), 27)
    p, s = ti._bottleneck(_sd(blk, "b"), "b", has_down)
    jm = JB(width=16, stride=stride, has_downsample=has_down)
    want = _run_jax(jm, {"params": p, "batch_stats": s}, _cl(x), train=False)
    np.testing.assert_allclose(_cl(_run_torch(blk, x)), want, atol=CONV_ATOL, rtol=0)


@pytest.fixture(scope="module")
def decoder_case():
    dec = _init(DecoderFuse(), seed=28)
    shapes = [(1, 24, 3, 16, 16), (1, 48, 3, 16, 16), (1, 96, 3, 8, 8),
              (1, 192, 3, 4, 4), (1, 192, 8, 8, 8)]
    xs = [_normal(s, 29 + i) for i, s in enumerate(shapes)]
    params = ti._decoder(_sd(dec, "decoder_fuse"))
    return dec.state_dict(), xs, params


# (fuse_depth, lean) on both sides: the plain resize-then-conv chain, and the
# default at B=1 (depth-fused, lean)
@pytest.mark.parametrize("fuse_depth,lean", [(False, False), (True, None)])
def test_decoder_fuse_matches_jax(decoder_case, fuse_depth, lean):
    from corrifnet_tpu.models.decoder import DecoderFuse as JD

    state, xs, params = decoder_case
    dec = DecoderFuse(fuse_depth=fuse_depth, lean=lean)
    dec.load_state_dict(state)
    got = _run_torch(dec.eval(), *xs)
    jm = JD(use_pallas_epilogue=True, fuse_depth=fuse_depth, lean=lean)
    fwd = jax.jit(lambda v, *a: jm.apply(v, *a, False))
    want = np.asarray(fwd({"params": params}, *(jnp.asarray(_cl(x)) for x in xs)))
    assert got.shape == want.shape == (1, 3, 1, 224, 224)
    np.testing.assert_allclose(got, want, atol=CONV_ATOL, rtol=0)


# ---------------------------------------------------------------- metrics


def _metric_columns(seed, empty=False):
    rng = np.random.default_rng(seed)
    y = (rng.random((500, 1)) > 0.6).astype(np.float32)
    if empty:
        y[:] = 0.0
    return y, rng.random((500, 1)).astype(np.float32)


@pytest.mark.parametrize("empty", [False, True])
def test_metrics_match_jax(empty):
    from corrifnet_tpu.metrics import jaccard2 as jj2, jaccard_f1_pair as jpair
    from corrifnet_tpu_torch.metrics import jaccard2, jaccard_f1_pair

    y, p = _metric_columns(30, empty)
    yt, pt = torch.from_numpy(y), torch.from_numpy(p)
    np.testing.assert_allclose(jaccard2(yt, pt).numpy(), np.asarray(jj2(y, p)),
                               rtol=1e-6)
    for got, want in zip(jaccard_f1_pair(yt, pt), jpair(y, p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("name, want", [("bfloat16", torch.bfloat16),
                                        ("float32", torch.float32)])
def test_evaluate_takes_compute_dtype_from_the_jax_config(tmp_path, name, want):
    from corrifnet_tpu_torch.config import load_config
    from corrifnet_tpu_torch.run.evaluate import compute_dtype

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"modeltype": "MMVit4", "dtype": name}))
    assert compute_dtype(load_config(path)) == want
