"""The port's kernel modules (corrifnet_tpu_torch.ops) against the JAX package.

Each kernel's plain PyTorch version is held against the JAX XLA path and
against the Pallas kernel run in interpret mode, in f32, on inputs made
from a fixed numpy seed. The kernels themselves (Triton, CUDA C++) run
only on the GPU; chip_smoke.py compares them with these plain versions
there. Here the wrappers are checked to take the plain version for CPU
tensors only, and to raise for a CUDA tensor when no kernel can be built.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrifnet_tpu.ops.attention as jax_attn
import corrifnet_tpu.ops.correlation as jax_corr
import corrifnet_tpu.ops.instancenorm as jax_in
from corrifnet_tpu_torch import ops
from corrifnet_tpu_torch.ops import attention as t_attn
from corrifnet_tpu_torch.ops import correlation as t_corr
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
    else:
        wrapper(torch.ones(1, 2, 2, 2, 8))
    assert wrapper.launches == before


def test_attention_wrapper_rejects_unsupported_shapes():
    bad = _cuda_looking((1, 1, 60, 64))
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.fused_attention(bad, bad, bad, 0.125)
