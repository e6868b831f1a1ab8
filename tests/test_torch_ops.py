"""The port's kernel modules (corrifnet_tpu_torch.ops) against the JAX package.

Each kernel's plain PyTorch version is held against the JAX XLA path and
against the Pallas kernel run in interpret mode, in f32, on inputs made
from a fixed numpy seed. The kernels themselves (Triton, CUDA C++) run
only on the GPU; chip_smoke.py compares them with these plain versions
there. Here the wrappers are checked to take the plain version for CPU
tensors only, and to raise for a CUDA tensor when no kernel can be built.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrifnet_tpu.ops.attention as jax_attn
import corrifnet_tpu.ops.correlation as jax_corr
import corrifnet_tpu.ops.fusedconv as jax_fc
import corrifnet_tpu.ops.instancenorm as jax_in
from corrifnet_tpu_torch import ops
from corrifnet_tpu_torch.ops import attention as t_attn
from corrifnet_tpu_torch.ops import correlation as t_corr
from corrifnet_tpu_torch.ops import fusedconv as t_fc
from corrifnet_tpu_torch.ops import instancenorm as t_in
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# f32 bounds: K1 and K3 differ from the JAX paths only by the order of f32
# sums; K2 sums 2048-long score rows and 2048-long PV products.
CORR_ATOL = 1e-6
ATTN_ATOL = 2e-5
IN_ATOL = 1e-5


def _normal(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(shift, scale, shape)).astype(np.float32)


def _interpret(mod):
    """Run a JAX ops module's Pallas kernel in interpret mode (CPU)."""

    class _Ctx:
        def __enter__(self):
            mod.INTERPRET = True

        def __exit__(self, *exc):
            mod.INTERPRET = False

    return _Ctx()


# ---------------------------------------------------------------- K1


def _corr_inputs(seed):
    # B=2 so that any mixing across the batch would show
    return [_normal((3, 2, 16, 128), seed + i) for i in range(3)]


def test_correlation_plain_matches_xla():
    q, k, v = _corr_inputs(0)
    got = t_corr.correlation_fusion_plain(*map(torch.from_numpy, (q, k, v)))
    want = jax_corr.correlation_fusion_xla(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CORR_ATOL, rtol=0)


def test_correlation_plain_matches_pallas_interpret():
    q, k, v = _corr_inputs(10)
    got = t_corr.correlation_fusion_plain(*map(torch.from_numpy, (q, k, v)))
    with _interpret(jax_corr):
        want = jax_corr.correlation_fusion(*map(jnp.asarray, (q, k, v)),
                                           use_pallas=True, block_rows=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CORR_ATOL, rtol=0)


def test_correlation_is_per_element_across_batch():
    q, k, v = _corr_inputs(20)
    full = ops.correlation_fusion(*map(torch.from_numpy, (q, k, v)))
    solo = ops.correlation_fusion(
        *(torch.from_numpy(np.ascontiguousarray(t[:, 1:2])) for t in (q, k, v))
    )
    np.testing.assert_array_equal(full[:, 1:2].numpy(), solo.numpy())


# ---------------------------------------------------------------- K2


def _attn_inputs(n, seed):
    return [_normal((1, 2, n, 64), seed + i) for i in range(3)]


@pytest.mark.parametrize("n", [512, 2048])
def test_attention_plain_matches_xla(n):
    q, k, v = _attn_inputs(n, 0)
    got = t_attn.attention_plain(*map(torch.from_numpy, (q, k, v)), 0.125)
    want = jax_attn.attention_xla(*map(jnp.asarray, (q, k, v)), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("n", [512, 2048])
def test_attention_plain_matches_pallas_interpret(n):
    q, k, v = _attn_inputs(n, 7)
    got = t_attn.attention_plain(*map(torch.from_numpy, (q, k, v)), 0.125)
    with _interpret(jax_attn):
        want = jax_attn.fused_attention(*map(jnp.asarray, (q, k, v)), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL, rtol=0)


def _packed_qkv(b, n, h, seed, dtype=torch.float32):
    """A (B, N, 3, H, 64) tensor as the qkv projection gives it, and its
    (B, H, N, 64) views q, k, v."""
    qkv = torch.from_numpy(_normal((b, n, 3, h, 64), seed)).to(dtype)
    return qkv, qkv.permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_on_strided_views_equals_contiguous(rate):
    """fused_attention and fused_attention_bwd on the strided (B, H, N, 64)
    views of a (B, N, 3, H, 64) tensor, with a (B, N, H, 64) cotangent,
    against the same calls on contiguous copies, and fused_attention_qkv
    against fused_attention under autograd: equal bits on the CPU."""
    b, n, h = 2, 128, 2
    qkv, views = _packed_qkv(b, n, h, 30)
    assert not any(t.is_contiguous() for t in views)
    g = torch.from_numpy(_normal((b, n, h, 64), 31)).permute(0, 2, 1, 3)
    copies = [t.contiguous() for t in views]
    philox = (7, 8) if rate else None
    out = ops.fused_attention(*views, 0.125, rate, philox)
    assert torch.equal(out, ops.fused_attention(*copies, 0.125, rate, philox))
    got = ops.fused_attention_bwd(*views, out, None, g, 0.125, rate, philox)
    want = ops.fused_attention_bwd(*copies, out, None, g.contiguous(), 0.125, rate, philox)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    packed = qkv.clone().requires_grad_()
    out_p = ops.fused_attention_qkv(packed, 0.125, rate, philox)
    assert out_p.shape == (b, h, n, 64) and torch.equal(out_p, out)
    out_p.backward(g)
    assert packed.grad.shape == qkv.shape
    for a, w in zip(packed.grad.permute(2, 0, 3, 1, 4).unbind(0), want):
        assert torch.equal(a, w)


def test_attention_qkv_rejects_other_shapes():
    with pytest.raises(ValueError, match=r"\(B, N, 3, H, D\)"):
        ops.fused_attention_qkv(torch.zeros(1, 64, 2, 1, 64), 0.125)
    with pytest.raises(ValueError, match=r"\(B, N, 3, H, D\)"):
        ops.fused_attention_qkv(torch.zeros(1, 1, 64, 64), 0.125)


def _bad_attention_operands(case):
    good = torch.zeros(1, 2, 128, 64)
    if case == "last dimension not contiguous":
        return [good, good, good.transpose(2, 3).contiguous().transpose(2, 3)]
    if case == "misaligned view":  # starts 8 bytes into a 16-byte row
        return [good, good, torch.zeros(1, 2, 128, 72)[..., 2:66]]
    if case == "row stride off the 16-byte grid":  # 68 bf16 = 136 bytes
        wide = torch.zeros(1, 2, 128, 68, dtype=torch.bfloat16)[..., :64]
        return [wide, wide, wide]
    if case == "head_dim 32":
        return [torch.zeros(1, 2, 128, 32)] * 3
    if case == "N not a multiple of the tile":
        return [torch.zeros(1, 2, 96, 64)] * 3
    if case == "mixed dtypes":
        return [good, good, good.bfloat16()]
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "last dimension not contiguous", "misaligned view", "row stride off the 16-byte grid",
    "head_dim 32", "N not a multiple of the tile", "mixed dtypes"])
def test_attention_check_rejects(case):
    """What the kernels do not take still raises; the check itself needs no
    card."""
    with pytest.raises(ValueError):
        t_attn._check(*_bad_attention_operands(case))


def test_attention_check_accepts_strided_views():
    for dtype in (torch.float32, torch.bfloat16):
        _, views = _packed_qkv(2, 64, 8, 32, dtype)
        t_attn._check(*views)
        out = torch.empty(2, 64, 8, 64, dtype=dtype).permute(0, 2, 1, 3)
        t_attn._check(*views, out)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_backward_plain_is_autograd_of_the_plain_forward(rate):
    """The explicit backward formulas (what K2b computes) against autograd
    through attention_plain, in f32: 2e-6 (sums in another order); and with
    the kernel's rounding points switched on in f32, where rounding to f32
    changes nothing: the same bound."""
    b, h, n = 2, 2, 128
    q, k, v, g = (torch.from_numpy(_normal((b, h, n, 64), 40 + i)) for i in range(4))
    keep = t_attn.philox_keep_mask(5, 6, b * h, n, rate).view(b, h, n, n) if rate else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.attention_plain(*leaves, 0.125, rate, keep)
    want = torch.autograd.grad(out, leaves, g)
    for rounding in (False, True):
        o = ops.attention_plain(q, k, v, 0.125, rate, keep, kernel_rounding=rounding)
        np.testing.assert_allclose(o.numpy(), out.detach().numpy(), atol=2e-6, rtol=0)
        got = ops.attention_backward_plain(q, k, v, o, None, g, 0.125, rate, keep,
                                           kernel_rounding=rounding)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w.numpy(), atol=2e-6, rtol=0)


def _bf16_ulp_of_max(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("n", [128, 512])
def test_attention_bf16_rounding_plain_matches_jax_bf16_kernel(n):
    """bf16 storage, rate 0: the plain versions with the GPU kernels'
    rounding points (``kernel_rounding=True``) against the Pallas forward and
    backward kernels in interpret mode on the same bf16 bits (f32 values from
    a numpy seed, rounded to bf16 once).

    The rounding points are not the TPU kernel's: it rounds the normalised p,
    folds the scale into a rounded k and takes ds from the rounded p
    (attention.py:313, 342, 354), where the GPU kernels round the
    unnormalised p, scale in f32 at the end and take ds from the f32 p. Both
    sides return bf16, so they differ by whole ulps: measured at most 1.5 bf16
    ulps of the largest entry (dk at n=128); the bound is 2. And the port is
    no further from attention_xla in f32 on the same inputs than the JAX bf16
    kernel itself is: within a factor 1.25 (measured 0.4 to 1.01)."""
    tensors = [torch.from_numpy(_normal((1, 2, n, 64), 150 + i)).bfloat16() for i in range(4)]
    q, k, v, g = tensors
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tensors)
    with _interpret(jax_attn):
        out_j, vjp = jax.vjp(lambda a, b, c: jax_attn.fused_attention(a, b, c, 0.125),
                             jq, jk, jv)
        grads_j = vjp(jg)
    out_x, vjp_x = jax.vjp(lambda a, b, c: jax_attn.attention_xla(a, b, c, 0.125),
                           *(a.astype(jnp.float32) for a in (jq, jk, jv)))
    grads_x = vjp_x(jg.astype(jnp.float32))
    out_t = ops.attention_plain(q, k, v, 0.125, kernel_rounding=True)
    grads_t = ops.attention_backward_plain(q, k, v, out_t, None, g, 0.125,
                                           kernel_rounding=True)
    assert out_t.dtype == torch.bfloat16 and out_j.dtype == jnp.bfloat16
    names = ("out", "dq", "dk", "dv")
    for name, t, j, x in zip(names, (out_t, *grads_t), (out_j, *grads_j), (out_x, *grads_x)):
        t = t.float().numpy()
        j, x = np.asarray(j.astype(jnp.float32)), np.asarray(x)
        ulp = _bf16_ulp_of_max(x)
        assert np.abs(t - j).max() <= 2 * ulp, (name, np.abs(t - j).max(), ulp)
        assert np.abs(t - x).max() <= 1.25 * np.abs(j - x).max(), name


def test_attention_bf16_rounding_plain_with_dropout_stays_near_f32():
    """Rate 0.1 in bf16 under one keep mask: the rounding plain versions
    against the same formulas in f32 on the same bf16 inputs, 2e-2 absolute on
    the output and 2e-2 of the largest gradient: the bounds the bf16 kernels
    are held to against f32 on the card."""
    rate, n = 0.1, 128
    q, k, v, g = (torch.from_numpy(_normal((2, 2, n, 64), 160 + i)).bfloat16()
                  for i in range(4))
    keep = t_attn.philox_keep_mask(21, 22, 4, n, rate).view(2, 2, n, n)
    out = ops.attention_plain(q, k, v, 0.125, rate, keep, kernel_rounding=True)
    ref = ops.attention_plain(q.float(), k.float(), v.float(), 0.125, rate, keep)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    got = ops.attention_backward_plain(q, k, v, out, None, g, 0.125, rate, keep,
                                       kernel_rounding=True)
    want = ops.attention_backward_plain(q.float(), k.float(), v.float(), ref, None,
                                        g.float(), 0.125, rate, keep)
    for a, w in zip(got, want):
        assert (a.float() - w).abs().max().item() <= 2e-2 * w.abs().max().item()


# ---------------------------------------------------------------- K3

# channel counts of the decoder (8..192) and 20, a partial 8-channel tile
_IN_SHAPES = [(2, 3, 8, 8, 8), (2, 4, 6, 6, 20), (2, 3, 5, 5, 24), (1, 2, 4, 4, 192)]


@pytest.mark.parametrize("shape", _IN_SHAPES)
def test_relu_instancenorm_plain_matches_xla(shape):
    x = _normal(shape, 1, shift=0.3)
    got = t_in.relu_instancenorm_plain(torch.from_numpy(x))
    want = jax_in.relu_instancenorm_xla(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=IN_ATOL, rtol=0)


@pytest.mark.parametrize("shape", _IN_SHAPES)
def test_relu_instancenorm_plain_matches_pallas_interpret(shape):
    x = _normal(shape, 2, shift=0.3)
    got = t_in.relu_instancenorm_plain(torch.from_numpy(x))
    with _interpret(jax_in):
        want = jax_in.relu_instancenorm(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=IN_ATOL, rtol=0)


# ---------------------------------------------------------------- K4

# the JAX suite's own bounds (tests/test_fusedconv.py): f32 sums in another order
_Y_TOL = dict(rtol=1e-5, atol=1e-5)
_S_TOL = dict(rtol=1e-4, atol=1e-3)
_Q_TOL = dict(rtol=1e-4, atol=1e-2)
_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _fold(ci, seed):
    """(a, b) of a previous BatchNorm: positive scales, small shifts."""
    return np.abs(_normal((ci,), seed)) + 0.5, _normal((ci,), seed + 1, 0.3)


def _t(*arrays):
    return [None if v is None else torch.from_numpy(v) for v in arrays]


def _j(*arrays):
    return [None if v is None else jnp.asarray(v) for v in arrays]


def _assert_stats_close(got, want):
    for g, w, tol in zip(got, want, (_Y_TOL, _S_TOL, _Q_TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("n,ci,co", [(1024, 192, 768), (700, 64, 256), (48, 33, 40)])
@pytest.mark.parametrize("prologue", [False, True])
def test_pointwise_conv_stats_matches_pallas_interpret(n, ci, co, prologue):
    x, w = _normal((n, ci), 0), _normal((ci, co), 1, 0.1)
    a, b = _fold(ci, 2) if prologue else (None, None)
    got = ops.pointwise_conv_stats(*_t(x, w, a, b))
    with _interpret(jax_fc):
        want = jax_fc.pointwise_conv_stats(*_j(x, w, a, b))
    _assert_stats_close(got, want)


@pytest.mark.parametrize("bt,h,w,ci,co", [(5, 12, 12, 32, 48), (2, 7, 9, 16, 16)])
def test_conv3x3_fma_relu_stats_matches_pallas_interpret(bt, h, w, ci, co):
    x, wk = _normal((bt, h, w, ci), 0), _normal((3, 3, ci, co), 1, 0.1)
    a, b = _fold(ci, 2)
    got = ops.conv3x3_fma_relu_stats(*_t(x, wk, a, b))
    with _interpret(jax_fc):
        want = jax_fc.conv3x3_fma_relu_stats(*_j(x, wk, a, b))
    _assert_stats_close(got, want)


_K4_GRAD_CASES = {
    "pointwise": ("pointwise_conv_stats", (260, 48), (48, 96), False),
    "pointwise_prologue": ("pointwise_conv_stats", (260, 48), (48, 96), True),
    "conv3x3": ("conv3x3_fma_relu_stats", (3, 9, 9, 16), (3, 3, 16, 24), True),
}


@pytest.mark.parametrize("case", sorted(_K4_GRAD_CASES))
def test_fused_conv_backward_matches_jax_vjp(case):
    """The hand-written backward (the plain formula on the CPU) against
    jax.vjp of the JAX entry point with its Pallas backward in interpret
    mode, with non-zero cotangents for y, s and q."""
    name, xs, ws, prologue = _K4_GRAD_CASES[case]
    ci, co = ws[-2:]
    x, w = _normal(xs, 0), _normal(ws, 1, 0.1)
    a, b = _fold(ci, 2) if prologue else (None, None)
    dy = _normal((*xs[:-1], co), 4, 0.7)
    ds, dq = _normal((co,), 5, 0.3), _normal((co,), 6, 0.01)

    leaves = [v.requires_grad_() for v in _t(x, w, a, b) if v is not None]
    out = getattr(ops, name)(*leaves)
    got = torch.autograd.grad(out, leaves, _t(dy, ds, dq))
    with _interpret(jax_fc):
        if prologue:
            _, vjp = jax.vjp(getattr(jax_fc, name), *_j(x, w, a, b))
        else:
            _, vjp = jax.vjp(lambda xx, ww: getattr(jax_fc, name)(xx, ww), *_j(x, w))
        want = vjp(tuple(_j(dy, ds, dq)))
    assert len(got) == len(want)
    for g, wnt, what in zip(got, want, ("dx", "dw", "da", "db")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), err_msg=what, **_GRAD_TOL)


@pytest.mark.parametrize("name", ["pointwise_conv_stats", "conv3x3_fma_relu_stats"])
def test_fused_conv_bf16_matches_jax(name):
    """bf16 storage: the rounding points (prologue in bf16, f32 accumulator,
    statistics before y is rounded) are the JAX kernel's, so y agrees to a
    bf16 ulp of its O(1) values (2e-2, the JAX suite's bound) and s to 2e-2
    relative + 2.0 (sums of ~1e3 rounded products)."""
    conv = name.startswith("conv")
    xs, ws = ((2, 8, 8, 32), (3, 3, 32, 48)) if conv else ((2, 3, 8, 8, 64), (64, 128))
    x = torch.from_numpy(_normal(xs, 0)).bfloat16()
    w = torch.from_numpy(_normal(ws, 1, 0.1)).bfloat16()
    a, b = _fold(xs[-1], 2)
    got = getattr(ops, name)(x, w, *_t(a, b))
    jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, w))
    with _interpret(jax_fc):
        want = getattr(jax_fc, name)(jx, jw, *_j(a, b))
    assert got[0].dtype == torch.bfloat16 and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-2, atol=2.0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-2, atol=2.0)


@pytest.mark.parametrize("name", ["pointwise_conv_stats", "conv3x3_fma_relu_stats"])
def test_fused_conv_missing_cotangents_are_zeros(name):
    conv = name.startswith("conv")
    xs, ws = ((2, 5, 6, 8), (3, 3, 8, 12)) if conv else ((30, 8), (8, 12))
    a, b = _fold(8, 2)
    leaves = [v.requires_grad_() for v in _t(_normal(xs, 0), _normal(ws, 1), a, b)]
    dy = torch.from_numpy(_normal((*xs[:-1], 12), 3))
    y, s, q = getattr(ops, name)(*leaves)
    only_y = torch.autograd.grad(y, leaves, dy)
    y, s, q = getattr(ops, name)(*leaves)
    zeros = torch.autograd.grad((y, s, q), leaves,
                                (dy, torch.zeros_like(s), torch.zeros_like(q)))
    for g, z in zip(only_y, zeros):
        assert torch.equal(g, z)
    y2, s2, q2 = getattr(ops, name)(*(v.detach() for v in leaves), stats=False)
    assert torch.equal(y2, y) and s2 is None and q2 is None


@pytest.mark.parametrize("rows,ci,co,taps", [
    (37632, 64, 64, 1), (37632, 64, 256, 1), (588, 2048, 512, 1),
    (588, 512, 2048, 1), (2352, 1024, 256, 1), (37632, 64, 64, 9), (588, 512, 512, 9),
])
def test_wgrad_plan_covers_the_rows(rows, ci, co, taps):
    """The weight-gradient pass's splits tile every row exactly once."""
    splits, chunk = t_fc.wgrad_plan(rows, ci, co, taps)
    assert splits >= 1 and chunk % 16 == 0
    assert (splits - 1) * chunk < rows <= splits * chunk


def _model_forward_shapes():
    """(rows, ci, co, taps) of every K4a and K4c call of MMVit4 at B=2, 4, 8:
    the depth of 3 folded into the rows, the four stages at 56, 28, 14, 7."""
    shapes = []
    for b in (2, 4, 8):
        r = [3 * b * side * side for side in (56, 28, 14, 7)]
        shapes += [
            (r[0], 64, 64, 1), (r[0], 64, 256, 1), (r[0], 256, 64, 1), (r[0], 256, 128, 1),
            (r[1], 128, 512, 1), (r[1], 256, 512, 1), (r[1], 512, 128, 1),
            (r[1], 512, 256, 1), (r[2], 256, 1024, 1), (r[2], 512, 1024, 1),
            (r[2], 1024, 256, 1), (r[2], 1024, 512, 1), (r[3], 512, 2048, 1),
            (r[3], 1024, 2048, 1), (r[3], 2048, 512, 1),
        ]
        shapes += [(r[i], c, c, 9) for i, c in enumerate((64, 128, 256, 512))]
    return shapes


@pytest.mark.parametrize("rows,ci,co,taps", _model_forward_shapes())
def test_forward_plan_covers_the_contraction(rows, ci, co, taps):
    """The bf16 forward's plan: the splits hold every contraction iteration
    once, none is empty, and the grid has at least the blocks the plan aims
    for (half the SMs of an H100) or is split as far as it goes (one
    iteration a split)."""
    block_n, splits, per = t_fc.forward_plan(rows, ci, co, taps)
    iters = taps * -(-ci // t_fc.WG_DEPTH)
    assert block_n in (64, 128) and splits >= 1 and per >= 1
    assert (splits - 1) * per < iters <= splits * per
    blocks = -(-rows // t_fc.WG_ROWS) * -(-co // block_n) * splits
    assert blocks >= t_fc.WG_BLOCKS or per == 1


@pytest.mark.parametrize("xs,co,taps", [((300, 64), 256, 1), ((588, 2048), 512, 1),
                                        ((12, 7, 7, 512), 512, 9)])
def test_forward_plan_does_not_depend_on_stats(xs, co, taps, monkeypatch):
    """The bf16 forward is launched with the same plan with and without the
    statistics (so y is the same bits), the plan of ``forward_plan``; the
    scratch it is given matches the plan."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(t_fc, "_library", lambda taps: (launch, None))
    monkeypatch.setattr(t_fc, "_counters", lambda x, size: torch.zeros(size))
    monkeypatch.setattr(t_fc, "_stream", lambda x: 0)
    ci = xs[-1]
    x = torch.zeros(xs, dtype=torch.bfloat16)
    w = torch.zeros((ci, co) if taps == 1 else (3, 3, ci, co), dtype=torch.bfloat16)
    a, b = torch.ones(ci), torch.zeros(ci)
    for stats in (True, False):
        t_fc._launch_forward(x, w, a, b, stats, taps)
    rows = x.numel() // ci
    plan = t_fc.forward_plan(rows, ci, co, taps)
    with_stats, without = (c[-4:-1] for c in calls)  # the plan, then the stream
    assert with_stats == without == plan
    assert calls[0][5] is not None and calls[1][5] is None  # the column partials
    assert (calls[0][7] is None) == (plan[1] == 1)  # split-K scratch


@pytest.mark.parametrize("rows,ci,co,taps", _model_forward_shapes()
                         + [(48, 33, 40, 1), (126, 16, 24, 9), (150, 1024, 256, 1),
                            (294, 256, 256, 9), (1, 8, 8, 1)])
def test_backward_plan_covers_the_rows(rows, ci, co, taps):
    """The bf16 backward's plan: the dx pass takes the forward's plan with
    the roles swapped (128 columns only where 128-column tiles are at least
    ``WG_BLOCKS``); the dw pass's splits hold every 64-pixel stage once,
    none is empty, a split holds at least ``DW_MIN_STAGES`` unless there is
    one, and the groups of splits cover the splits with no empty group."""
    dx, (splits, per, group) = t_fc.backward_plan(rows, ci, co, taps)
    assert dx == t_fc.forward_plan(rows, co, ci, taps, dx[0])
    tiles128 = -(-rows // t_fc.WG_ROWS) * -(-ci // 128)
    assert dx[0] == (128 if ci > 64 and tiles128 >= t_fc.WG_BLOCKS else 64)
    stages = -(-rows // t_fc.DW_STAGE)
    assert splits >= 1 and per >= 1 and group >= 1
    assert (splits - 1) * per < stages <= splits * per
    assert splits == 1 or per >= t_fc.DW_MIN_STAGES
    groups = -(-splits // group)
    assert (groups - 1) * group < splits <= groups * group
    assert max(group, groups) <= math.isqrt(splits) + 1


@pytest.mark.parametrize("xs,co,taps,pro", [((300, 64), 256, 1, True),
                                            ((37632, 64), 64, 1, False),
                                            ((12, 7, 7, 512), 512, 9, True)])
def test_backward_launch_takes_the_plan(xs, co, taps, pro, monkeypatch):
    """The bf16 backward is launched with ``backward_plan``'s plan and
    scratch of its size; the f32 backward with ``wgrad_plan`` and no g,
    split scratch or counters."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(t_fc, "_library", lambda taps: (None, launch))
    monkeypatch.setattr(t_fc, "_counters", lambda x, size: torch.zeros(size))
    monkeypatch.setattr(t_fc, "_stream", lambda x: 0)
    monkeypatch.setattr(t_fc, "_ptr", lambda t: t)  # the launch sees the tensors
    ci = xs[-1]
    a, b = (torch.ones(ci), torch.zeros(ci)) if pro else (None, None)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros(xs, dtype=dtype)
        w = torch.zeros((ci, co) if taps == 1 else (3, 3, ci, co), dtype=dtype)
        y = torch.zeros((*xs[:-1], co), dtype=dtype)
        t_fc._launch_backward(x, w, a, b, y, y, torch.zeros(co), torch.zeros(co), taps)
    rows = int(np.prod(xs[:-1]))
    (dx_n, dx_splits, dx_per), dw = t_fc.backward_plan(rows, ci, co, taps)
    bf, f32 = calls
    assert bf[-7:-1] == (dx_n, dx_splits, dx_per, *dw) and f32[-7:-1] == (0,) * 6
    assert bf[13] is not None and (bf[14] is None) == (dx_splits == 1)
    assert (bf[12] is None) == (dw[0] == 1) and bf[15] is not None
    if dw[0] > 1:  # the split partials, then the groups' sums
        tiles = -(-ci // t_fc.DW_TILE) * -(-co // t_fc.DW_TILE) * taps
        groups = -(-dw[0] // dw[2])
        assert bf[12].shape == (tiles, dw[0] + groups, t_fc.DW_TILE, t_fc.DW_TILE)
    assert f32[13] is None and f32[14] is None and f32[15] is None


# ---------------------------------------------------------------- wrappers


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(shape):
    return torch.Tensor._make_subclass(_CudaLooking, torch.zeros(shape))


_WRAPPER_CASES = {
    "correlation_fusion": (t_corr, "correlation_fusion_plain",
                           lambda: [_cuda_looking((3, 1, 4, 8))] * 3),
    "fused_attention": (t_attn, "attention_plain",
                        lambda: [_cuda_looking((1, 1, 64, 64))] * 3 + [0.125]),
    "relu_instancenorm": (t_in, "relu_instancenorm_plain",
                          lambda: [_cuda_looking((1, 2, 2, 2, 8))]),
    "relu_instancenorm_bwd": (t_in, "relu_instancenorm_backward_plain",
                              lambda: [_cuda_looking((1, 2, 2, 2, 8))] * 2
                              + [_cuda_looking((1, 8))] * 2),
    "pointwise_conv_stats": (t_fc, "pointwise_conv_stats_plain",
                             lambda: [_cuda_looking((4, 8)), _cuda_looking((8, 8))]),
    "conv3x3_fma_relu_stats": (
        t_fc, "conv3x3_fma_relu_stats_plain",
        lambda: [_cuda_looking((1, 2, 2, 8)), _cuda_looking((3, 3, 8, 8)),
                 _cuda_looking((8,)), _cuda_looking((8,))]),
    "pointwise_conv_stats_bwd": (
        t_fc, "pointwise_conv_stats_backward_plain",
        lambda: [_cuda_looking((4, 8)), _cuda_looking((8, 8)), None, None,
                 _cuda_looking((4, 8)), _cuda_looking((4, 8)), _cuda_looking((8,)),
                 _cuda_looking((8,))]),
    "conv3x3_fma_relu_stats_bwd": (
        t_fc, "conv3x3_fma_relu_stats_backward_plain",
        lambda: [_cuda_looking((1, 2, 2, 8)), _cuda_looking((3, 3, 8, 8)),
                 _cuda_looking((8,)), _cuda_looking((8,)), _cuda_looking((1, 2, 2, 8)),
                 _cuda_looking((1, 2, 2, 8)), _cuda_looking((8,)), _cuda_looking((8,))]),
}


@pytest.mark.parametrize("name", sorted(_WRAPPER_CASES))
def test_wrapper_raises_for_cuda_tensor_without_kernel(name, monkeypatch):
    """No nvcc and no triton here: a CUDA tensor must raise, never reach the
    plain version, and count no launch."""
    module, plain_name, make_args = _WRAPPER_CASES[name]
    calls = []
    monkeypatch.setattr(module, plain_name, lambda *a, **k: calls.append(a))
    wrapper = ops.KERNELS[name]
    before = wrapper.launches
    with pytest.raises((ImportError, OSError, RuntimeError)):
        wrapper(*make_args())
    assert calls == [] and wrapper.launches == before


@pytest.mark.parametrize("name", sorted(_WRAPPER_CASES))
def test_wrapper_on_cpu_counts_no_launch(name):
    wrapper = ops.KERNELS[name]
    before = wrapper.launches
    if name == "correlation_fusion":
        wrapper(*(torch.ones(3, 1, 2, 4) for _ in range(3)))
    elif name == "fused_attention":
        wrapper(*(torch.ones(1, 1, 64, 64) for _ in range(3)), 0.125)
    elif name == "relu_instancenorm":
        wrapper(torch.ones(1, 2, 2, 2, 8))
    elif name == "relu_instancenorm_bwd":
        wrapper(torch.ones(1, 2, 2, 2, 8), torch.ones(1, 2, 2, 2, 8), torch.ones(1, 8),
                torch.ones(1, 8))
    else:
        conv = name.startswith("conv")
        x = torch.ones((1, 2, 2, 8) if conv else (4, 8))
        w = torch.ones((3, 3, 8, 8) if conv else (8, 8))
        args = [x, w, torch.ones(8), torch.ones(8)]
        if name.endswith("_bwd"):
            args += [x, x, torch.ones(8), torch.ones(8)]
        wrapper(*args)
    assert wrapper.launches == before


def test_attention_wrapper_rejects_unsupported_shapes():
    bad = _cuda_looking((1, 1, 60, 64))
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.fused_attention(bad, bad, bad, 0.125)
