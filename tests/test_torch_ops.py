"""The port's kernel modules (corrifnet_tpu_torch.ops) against the JAX package.

Each kernel's plain PyTorch version is held against the JAX XLA path and
against the Pallas kernel run in interpret mode, in f32, on inputs made
from a fixed numpy seed. The kernels themselves (Triton, CUDA C++) run
only on the GPU; chip_smoke.py compares them with these plain versions
there. Here the wrappers are checked to take the plain version for CPU
tensors only, and to raise for a CUDA tensor when no kernel can be built.
"""

from __future__ import annotations

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


# (B, N, C) of the 27 ReLU+IN epilogues of one B=8 forward, by distinct shape
_SLICE_IN_SHAPES = [
    (8, 512, 192), (8, 588, 192), (8, 2352, 96), (8, 9408, 48), (8, 9408, 24),
    (8, 16 ** 3, 128), (8, 16 ** 3, 64), (8, 32 ** 3, 32), (8, 64 ** 3, 16),
    (8, 128 ** 3, 8),
]


@pytest.mark.parametrize("b,n,c", _SLICE_IN_SHAPES)
def test_relu_instancenorm_launch_plan_covers_volume(b, n, c):
    """The split reduction's chunks tile every row exactly once and each
    tile holds whole channel rows."""
    block_n, block_c, rows_per_chunk, n_chunks = t_in._launch_plan(b, n, c)
    assert block_c >= c and block_c & (block_c - 1) == 0
    assert block_n & (block_n - 1) == 0 and block_n * block_c <= t_in._TILE_ELEMS
    assert rows_per_chunk % block_n == 0
    assert (n_chunks - 1) * rows_per_chunk < n <= n_chunks * rows_per_chunk
    assert b * n_chunks <= t_in._STAT_PROGRAMS


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
