"""Fused ReLU + InstanceNorm, the epilogue of every decoder conv block.

Counterpart of ``relu_instancenorm`` / ``relu_instancenorm_xla`` in
``corrifnet_tpu/ops/instancenorm.py``: ``y = relu(x)``, then per (sample,
channel) the mean and biased variance over all spatial positions, then
``(y - mean) * rsqrt(var + eps)``. Layout is the JAX one, channels-last
``(B, D, H, W, C)``.

Kernel K3 is Triton and replaces the TPU kernel ``_kernel`` that
``_fused_fwd`` runs through ``pl.pallas_call``
(``corrifnet_tpu/ops/instancenorm.py:67-77,98-119``). The TPU kernel holds a
whole (channels, N) row block in fast memory and gives way to XLA when one
8-channel row does not fit (every 64^3 and 128^3 decoder volume). On the
H100 the op is bound by device-memory bandwidth (two reads of x and one
write of y at the 128^3 x 8 volumes, 268 MB per read at B=8 in bf16), and
blocks cannot carry a sum from one to the next, so the reduction is split:

  1. stats: grid (sample, chunk of rows); each program walks its chunk in
     (BLOCK_N, C) tiles, takes each tile's exact mean and M2 and merges
     them into running (mean, M2) with Chan's formula — the two-pass
     accuracy of the TPU kernel from one read of x;
  2. merge: grid (sample,); the chunk statistics merge the same way into
     the per-channel mean and rsqrt(var + eps);
  3. normalize: grid (sample, tile of rows); relu, normalize in f32, store
     in the input dtype.

There is no size-based fallback: any N and any C (C is padded to a power
of two inside a tile and masked).

``relu_instancenorm`` is differentiable. Its backward is the plain PyTorch
formula from the saved input, not a kernel: the JAX package has no backward
kernel for this op either (its ``_vjp_bwd``, ``instancenorm.py:142-144``,
differentiates ``relu_instancenorm_xla``). It takes the plain version below
only for tensors on the CPU; for CUDA tensors the forward launches the
kernel or raises.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["relu_instancenorm", "relu_instancenorm_backward_plain",
           "relu_instancenorm_plain"]

_TILE_ELEMS = 4096  # elements of one (BLOCK_N, BLOCK_C) tile
_STAT_PROGRAMS = 1024  # target number of stats programs over the batch


def relu_instancenorm_plain(x, eps=1e-5):
    """Plain PyTorch version: two-pass f32 statistics, as the TPU kernel."""
    axes = tuple(range(1, x.dim() - 1))
    y = torch.relu(x).float()
    mean = y.mean(dim=axes, keepdim=True)
    d = y - mean
    var = (d * d).mean(dim=axes, keepdim=True)
    return (d * torch.rsqrt(var + eps)).to(x.dtype)


def relu_instancenorm_backward_plain(x, g, eps=1e-5):
    """dx of ``relu_instancenorm_plain`` for the output gradient ``g``, from
    the saved input: f32 inside, result in x's dtype."""
    axes = tuple(range(1, x.dim() - 1))
    y = torch.relu(x).float()
    mean = y.mean(dim=axes, keepdim=True)
    d = y - mean
    rstd = torch.rsqrt((d * d).mean(dim=axes, keepdim=True) + eps)
    xhat = d * rstd
    gf = g.float()
    dy = rstd * (gf - gf.mean(dim=axes, keepdim=True)
                 - xhat * (gf * xhat).mean(dim=axes, keepdim=True))
    return torch.where(x > 0, dy, torch.zeros_like(dy)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Compiled on first use: triton exists only where there is a GPU."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def stats(x_ptr, mean_ptr, m2_ptr, N, C, rows_per_chunk, n_chunks,
              BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        ch = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        base = x_ptr + b.to(tl.int64) * N * C
        row0 = ch * rows_per_chunk
        row_end = tl.minimum(row0 + rows_per_chunk, N)
        mean = tl.zeros([BLOCK_C], dtype=tl.float32)
        m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for start in range(row0, row_end, BLOCK_N):
            rows = start + tl.arange(0, BLOCK_N)
            rmask = rows < row_end
            mask = rmask[:, None] & cmask[None, :]
            x = tl.load(base + rows[:, None] * C + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32)
            y = tl.maximum(x, 0.0)
            n_t = tl.minimum(row_end - start, BLOCK_N).to(tl.float32)
            n_a = (start - row0).to(tl.float32)
            t_mean = tl.sum(y, axis=0) / n_t
            d = tl.where(mask, y - t_mean[None, :], 0.0)
            t_m2 = tl.sum(d * d, axis=0)
            n_ab = n_a + n_t
            delta = t_mean - mean
            mean = mean + delta * (n_t / n_ab)
            m2 = m2 + t_m2 + delta * delta * (n_a * n_t / n_ab)
        out = (b * n_chunks + ch) * C + cols
        tl.store(mean_ptr + out, mean, mask=cmask)
        tl.store(m2_ptr + out, m2, mask=cmask)

    @triton.jit
    def merge(mean_ptr, m2_ptr, shift_ptr, scale_ptr, N, C, rows_per_chunk,
              n_chunks, eps, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = tl.zeros([BLOCK_C], dtype=tl.float32)
        m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for ch in range(0, n_chunks):
            n_a = (ch * rows_per_chunk).to(tl.float32)
            n_t = tl.minimum(rows_per_chunk, N - ch * rows_per_chunk).to(tl.float32)
            src = (b * n_chunks + ch) * C + cols
            t_mean = tl.load(mean_ptr + src, mask=cmask, other=0.0)
            t_m2 = tl.load(m2_ptr + src, mask=cmask, other=0.0)
            n_ab = n_a + n_t
            delta = t_mean - mean
            mean = mean + delta * (n_t / n_ab)
            m2 = m2 + t_m2 + delta * delta * (n_a * n_t / n_ab)
        rstd = 1.0 / tl.sqrt(m2 / N + eps)
        tl.store(shift_ptr + b * C + cols, mean, mask=cmask)
        tl.store(scale_ptr + b * C + cols, rstd, mask=cmask)

    @triton.jit
    def normalize(x_ptr, shift_ptr, scale_ptr, o_ptr, N, C,
                  BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        rows = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        mask = (rows < N)[:, None] & cmask[None, :]
        offs = b.to(tl.int64) * N * C + rows[:, None] * C + cols[None, :]
        mean = tl.load(shift_ptr + b * C + cols, mask=cmask, other=0.0)
        rstd = tl.load(scale_ptr + b * C + cols, mask=cmask, other=0.0)
        y = tl.maximum(tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32), 0.0)
        out = (y - mean[None, :]) * rstd[None, :]
        tl.store(o_ptr + offs, out.to(o_ptr.dtype.element_ty), mask=mask)

    return stats, merge, normalize


def _launch_plan(b, n, c):
    """(BLOCK_N, BLOCK_C, rows_per_chunk, n_chunks) for a (b, n, c) volume."""
    block_c = 1 << max(c - 1, 0).bit_length()
    block_n = max(1, _TILE_ELEMS // block_c)
    tiles = -(-n // block_n)
    chunks = min(tiles, max(1, _STAT_PROGRAMS // b))
    rows_per_chunk = -(-tiles // chunks) * block_n
    return block_n, block_c, rows_per_chunk, -(-n // rows_per_chunk)


def _launch(x, eps):
    """Kernel K3 on a CUDA tensor."""
    if x.dim() < 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16 (B, *spatial, C), "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("kernel takes a contiguous channels-last volume")
    stats, merge, normalize = _kernels()
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // (b * c)
    block_n, block_c, rows_per_chunk, n_chunks = _launch_plan(b, n, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    chunk_mean = torch.empty((b, n_chunks, c), **f32)
    chunk_m2 = torch.empty((b, n_chunks, c), **f32)
    stats[(b, n_chunks)](x, chunk_mean, chunk_m2, n, c, rows_per_chunk,
                         n_chunks, BLOCK_N=block_n, BLOCK_C=block_c,
                         num_warps=4)
    shift = torch.empty((b, c), **f32)
    scale = torch.empty((b, c), **f32)
    merge[(b,)](chunk_mean, chunk_m2, shift, scale, n, c, rows_per_chunk,
                n_chunks, float(eps), BLOCK_C=block_c, num_warps=1)
    out = torch.empty_like(x)
    normalize[(b, -(-n // block_n))](x, shift, scale, out, n, c,
                                     BLOCK_N=block_n, BLOCK_C=block_c,
                                     num_warps=4)
    relu_instancenorm.launches += 1
    return out


class _ReluInstanceNorm(torch.autograd.Function):
    """K3 forward; the backward is the plain formula from the saved input."""

    @staticmethod
    def forward(ctx, x, eps):
        ctx.save_for_backward(x)
        ctx.eps = eps
        return _launch(x, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return relu_instancenorm_backward_plain(x, g, ctx.eps), None


def relu_instancenorm(x, eps=1e-5):
    """Channels-last (B, *spatial, C) ReLU + InstanceNorm, differentiable.
    CPU tensors: the plain version. CUDA tensors: kernel K3, or an
    exception; never the plain version in the forward."""
    if x.device.type == "cpu":
        return relu_instancenorm_plain(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no instancenorm kernel for device {x.device}")
    _kernels()  # a missing compiler raises here, before autograd is involved
    return _ReluInstanceNorm.apply(x, eps)


relu_instancenorm.launches = 0
