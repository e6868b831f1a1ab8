"""K3 and K3b, the port's ReLU + InstanceNorm and its backward, on the CPU.

The kernels (``corrifnet_tpu_torch/csrc/instancenorm.cu``) run only on the
GPU, where chip_smoke.py and tests/test_torch_gpu.py hold them against the
plain versions. Here: the plan that cuts every launch (pure Python), at the
27 decoder shapes at B = 1, 4 and 8 and at edge shapes, and the plain
backward (with and without the forward's saved statistics) against
``jax.vjp`` of the JAX package's ``relu_instancenorm``, on inputs made from
a numpy seed.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrifnet_tpu.ops.instancenorm as jax_in
from corrifnet_tpu_torch import ops
from corrifnet_tpu_torch.ops import instancenorm as t_in
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

IN_ATOL = 1e-5  # f32 statistics over the volume, summed in another order
H100_SMS = 132

# the decoder's 27 ReLU+IN epilogues, by distinct (D, H, W, C) (chip_smoke.k3_shapes)
_MAIN_PATH = [
    (8, 8, 8, 192), (3, 14, 14, 192), (3, 28, 28, 96), (3, 56, 56, 48), (3, 56, 56, 24),
    (16, 16, 16, 128), (16, 16, 16, 64), (32, 32, 32, 32), (64, 64, 64, 16),
    (128, 128, 128, 8),
]
# (B, N, C): C not a multiple of 8, N not a multiple of any tile, N = 1, the
# largest C, and more samples than blocks
_EDGES = [(2, 1000, 20), (3, 100003, 8), (1, 1, 8), (5, 1, 20), (2, 777, 1024),
          (300, 4096, 64), (1, 129 ** 3, 8)]


def _check_plan(b, n, c, max_blocks):
    """Every launch the plan makes for (b, n, c), in both dtypes, forward and
    backward: each row of each sample is covered once; the rows a block
    keeps fit its shared memory; the grid is within the co-resident bound;
    the barrier and the partials buffer match the launch."""
    for itemsize in (2, 4):
        for backward in (False, True):
            p = t_in.plan(b, n, c, itemsize, backward, max_blocks)
            # rows: chunks tile [0, n) with no gap, no overlap, none empty
            assert p.chunks * p.chunk_rows >= n > (p.chunks - 1) * p.chunk_rows
            # samples: round r takes samples [r per_round, (r + 1) per_round)
            assert p.rounds * p.per_round >= b > (p.rounds - 1) * p.per_round
            seen = sorted(r * p.per_round + blk // p.chunks
                          for r in range(p.rounds) for blk in range(0, p.grid, p.chunks))
            assert [s for s in seen if s < b] == list(range(b))
            assert p.grid == p.per_round * p.chunks
            if p.regime == "grid":  # a grid barrier: every block resident at once
                assert p.grid <= max_blocks
            else:  # no grid barrier: a block alone, or a cluster of at most
                # MAX_CLUSTER blocks taking every sample in one round
                assert p.chunks <= t_in.MAX_CLUSTER
                assert p.regime == "slab" or p.rounds == 1
            # on chip: the kept rows and the reduction's scratch, within the limit
            row_bytes = 8 * math.ceil(c / 8) * itemsize * (2 if backward else 1)
            assert 0 <= p.resident_rows <= p.chunk_rows
            assert p.smem == t_in.fixed_smem_bytes(c) + p.resident_rows * row_bytes
            assert p.smem <= t_in.SMEM_LIMIT
            if p.resident_rows < p.chunk_rows:  # the rest is read again: the budget is full
                assert p.smem + row_bytes > t_in.SMEM_LIMIT
                # more than one sample a round only while few rows are read again
                streamed = 1 - p.resident_rows / min(p.chunk_rows, n)
                assert p.per_round == 1 or streamed <= t_in.MAX_STREAMED
            # one chunk a sample needs no barrier; a cluster meets at its own
            assert (p.regime == "slab") == (p.chunks == 1)
            assert p.barrier_words == (2 if p.regime == "grid" else 0)
            assert p.partial_floats == b * p.chunks * 2 * c


@pytest.mark.parametrize("batch", [1, 4, 8])
@pytest.mark.parametrize("shape", _MAIN_PATH, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_main_path_shapes(shape, batch):
    _check_plan(batch, math.prod(shape[:-1]), shape[-1], H100_SMS)


@pytest.mark.parametrize("b,n,c", _EDGES)
def test_plan_covers_edge_shapes(b, n, c):
    _check_plan(b, n, c, H100_SMS)
    _check_plan(b, n, c, 7)  # smaller cards
    _check_plan(b, n, c, 1)


def test_plan_regimes():
    """A volume small enough for one vector a thread is one block a sample
    (no barrier); a sample that fits the shared memory of a cluster is a
    cluster, every sample at once; the larger volumes spread over the whole
    card, the 128^3 one a sample at a time with most of it on chip in bf16."""
    assert t_in.plan(4, 16, 192, 2).regime == "slab"
    small = t_in.plan(4, 512, 192, 2)
    assert small.regime == "cluster" and small.chunks == t_in.MAX_CLUSTER
    assert small.rounds == 1 and small.grid == 4 * t_in.MAX_CLUSTER
    assert t_in.plan(4, 16 ** 3, 128, 2).regime == "cluster"
    assert t_in.plan(4, 16 ** 3, 128, 2, backward=True).regime == "grid"
    assert t_in.plan(4, 32 ** 3, 32, 2).regime == "grid"
    big = t_in.plan(4, 128 ** 3, 8, 2)
    assert big.regime == "grid" and big.grid == H100_SMS and big.rounds == 4
    assert big.resident_rows / big.chunk_rows > 0.85
    # 64^3 x 16: all four samples in one round, a sixth of the rows read again
    mid = t_in.plan(4, 64 ** 3, 16, 2)
    assert mid.rounds == 1 and 0.75 < mid.resident_rows / mid.chunk_rows < 1
    with pytest.raises(ValueError):
        t_in.plan(1, 8, t_in.MAX_CHANNELS + 1, 2)


# ---------------------------------------------------------------- backward

# channel counts of the decoder (8..192) and 20, a partial 8-channel vector
_IN_SHAPES = [(2, 3, 8, 8, 8), (2, 4, 6, 6, 20), (2, 3, 5, 5, 24), (1, 2, 4, 4, 192)]


def _normal(shape, seed, shift=0.0):
    return np.random.default_rng(seed).normal(shift, 1.0, shape).astype(np.float32)


def _jax_vjp(x, g, reference):
    fn = jax_in.relu_instancenorm_xla if reference == "xla" else jax_in.relu_instancenorm
    jax_in.INTERPRET = reference == "pallas_interpret"
    try:
        _, pullback = jax.vjp(fn, jnp.asarray(x))
        return np.asarray(pullback(jnp.asarray(g))[0])
    finally:
        jax_in.INTERPRET = False


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("shape", _IN_SHAPES)
def test_backward_plain_matches_jax_vjp(shape, reference):
    """The plain backward, from x alone and from the saved statistics, and
    the CPU wrapper of K3b, against jax.vjp of relu_instancenorm (its XLA
    path, or the Pallas kernel in interpret mode whose custom VJP is
    ``_vjp_bwd``): 1e-5. The saved-statistics variant is the same bits."""
    x, g = _normal(shape, 90, shift=0.3), _normal(shape, 91)
    want = _jax_vjp(x, g, reference)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    mean, rstd = ops.relu_instancenorm_stats_plain(xt)
    assert mean.shape == rstd.shape == (shape[0], shape[-1])
    formula = ops.relu_instancenorm_backward_plain(xt, gt)
    saved = ops.relu_instancenorm_backward_plain(xt, gt, 1e-5, mean, rstd)
    wrapper = ops.relu_instancenorm_bwd(xt, gt, mean, rstd)
    np.testing.assert_allclose(formula.numpy(), want, atol=IN_ATOL, rtol=0)
    assert torch.equal(saved, formula) and torch.equal(wrapper, formula)


def test_stats_match_the_forward():
    """The statistics the backward takes are those the plain forward
    normalizes with: y = (relu(x) - mean) * rstd, bit for bit."""
    x = torch.from_numpy(_normal((2, 3, 4, 5, 16), 92, shift=0.2))
    mean, rstd = ops.relu_instancenorm_stats_plain(x)
    y = ((torch.relu(x) - mean[:, None, None, None]) * rstd[:, None, None, None])
    assert torch.equal(y, ops.relu_instancenorm_plain(x))
