"""Fused ReLU + InstanceNorm, the epilogue of every decoder conv block.

Counterpart of ``relu_instancenorm`` / ``relu_instancenorm_xla`` in
``corrifnet_tpu/ops/instancenorm.py``: ``y = relu(x)``, then per (sample,
channel) the mean and biased variance over all spatial positions, then
``(y - mean) * rsqrt(var + eps)``. Layout is the JAX one, channels-last
``(B, D, H, W, C)``.

Both kernels are CUDA C++ (``csrc/instancenorm.cu``), one launch a call.
K3, the forward, replaces the TPU kernel ``_kernel`` that ``_fused_fwd``
runs through ``pl.pallas_call`` (``corrifnet_tpu/ops/instancenorm.py:67-77,
98-119``); it also writes the per-(sample, channel) mean and rstd, which the
backward takes instead of computing them again. K3b, the backward, has no
TPU kernel to replace: it stands for XLA's fusion of the JAX module's
``_vjp_bwd`` (``instancenorm.py:142-144``, which differentiates
``relu_instancenorm_xla``). The op is bound by device-memory bytes; ``plan``
cuts each sample into row chunks, one thread block each, so that a block
keeps its rows in shared memory between the reduction and the write (see
the source's note for the design and what it keeps on chip).

``relu_instancenorm`` is differentiable. The wrappers take the plain
versions below only for tensors on the CPU; for CUDA tensors they launch
their kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from corrifnet_tpu_torch.ops.build import PLAIN_DEVICES, load_cuda_library

__all__ = ["Plan", "plan", "relu_instancenorm", "relu_instancenorm_backward_plain",
           "relu_instancenorm_bwd", "relu_instancenorm_plain",
           "relu_instancenorm_stats_plain"]

THREADS = 384          # threads a block (csrc/instancenorm.cu kThreads)
MAX_CHANNELS = 1024    # csrc/instancenorm.cu kMaxChannels
SMEM_LIMIT = 232448    # dynamic shared memory a block may have on Hopper
MAX_CLUSTER = 8        # blocks of a cluster (csrc/instancenorm.cu kMaxCluster)
MAX_STREAMED = 0.25    # share of a chunk's rows a round may leave to be read again
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain versions


def relu_instancenorm_stats_plain(x, eps=1e-5):
    """(mean, rstd) of ``relu(x)`` per (sample, channel), f32 ``(B, C)``:
    two-pass f32 statistics, as the TPU kernel."""
    axes = tuple(range(1, x.dim() - 1))
    y = torch.relu(x).float()
    mean = y.mean(dim=axes, keepdim=True)
    d = y - mean
    rstd = torch.rsqrt((d * d).mean(dim=axes, keepdim=True) + eps)
    return mean.reshape(x.shape[0], -1), rstd.reshape(x.shape[0], -1)


def relu_instancenorm_plain(x, eps=1e-5):
    """Plain PyTorch version: two-pass f32 statistics, as the TPU kernel."""
    axes = tuple(range(1, x.dim() - 1))
    y = torch.relu(x).float()
    mean = y.mean(dim=axes, keepdim=True)
    d = y - mean
    var = (d * d).mean(dim=axes, keepdim=True)
    return (d * torch.rsqrt(var + eps)).to(x.dtype)


def relu_instancenorm_backward_plain(x, g, eps=1e-5, mean=None, rstd=None):
    """dx of ``relu_instancenorm_plain`` for the output gradient ``g``, from
    the saved input: f32 inside, result in x's dtype. ``mean`` and ``rstd``
    (f32 ``(B, C)``, as the forward kernel saves them) replace the
    statistics computed again from x; given those of
    ``relu_instancenorm_stats_plain`` the result is the same bits."""
    axes = tuple(range(1, x.dim() - 1))
    if mean is None:
        mean, rstd = relu_instancenorm_stats_plain(x, eps)
    view = (x.shape[0],) + (1,) * len(axes) + (x.shape[-1],)
    xhat = (torch.relu(x).float() - mean.view(view)) * rstd.view(view)
    gf = g.float()
    dy = rstd.view(view) * (gf - gf.mean(dim=axes, keepdim=True)
                            - xhat * (gf * xhat).mean(dim=axes, keepdim=True))
    return torch.where(x > 0, dy, torch.zeros_like(dy)).to(x.dtype)


# ------------------------------------------------------------------ the plan


class Plan(NamedTuple):
    """How one call is cut: every sample into ``chunks`` row ranges of
    ``chunk_rows`` rows (the last may be shorter), one block each, with
    ``per_round`` samples at a time over ``rounds`` rounds (``grid`` =
    per_round * chunks blocks, a grid barrier a round when chunks > 1); a
    block keeps the first ``resident_rows`` of its rows in shared memory
    (``smem`` bytes with the reduction's scratch) and reads the rest again.
    ``regime``: "slab" where a block owns a whole sample (no barrier);
    "cluster" where the chunks of a sample (at most ``MAX_CLUSTER``) are one
    thread block cluster and meet at its hardware barrier, all samples in
    one round; "grid" where all blocks meet at a grid barrier, the grid
    co-resident (a cooperative launch)."""

    regime: str
    chunks: int
    chunk_rows: int
    per_round: int
    rounds: int
    resident_rows: int
    grid: int
    smem: int
    partial_floats: int  # f32 scratch: (B, chunks, 2, C)
    barrier_words: int   # 2 with a barrier, else 0


def fixed_smem_bytes(c):
    """Shared memory a block takes besides the rows it keeps: the block
    reduction's scratch and the per-channel values (csrc/instancenorm.cu)."""
    cp = 8 * -(-c // 8)
    return -(-(THREADS * 8 + max(THREADS, cp) + 4 * cp) // 4) * 16


def _streamed(n, chunk_rows, rows_fit):
    """The share of a chunk's rows that do not fit on chip."""
    return max(0, min(chunk_rows, n) - rows_fit) / min(chunk_rows, n)


def plan(b, n, c, itemsize, backward=False, max_blocks=132):
    """The launch of one K3 (or, ``backward``, K3b) call on ``b`` samples of
    ``n`` rows of ``c`` channels of ``itemsize`` bytes, on a card where at
    most ``max_blocks`` blocks of this kernel are resident at once (one per
    SM: 132 on an H100 SXM).

    A block keeps a row on chip in ``8 * ceil(c / 8) * itemsize`` bytes per
    operand (x; the backward also g). A sample that fits the shared memory
    of ``MAX_CLUSTER`` blocks is a cluster; otherwise as many samples are
    taken a round as leave at most ``MAX_STREAMED`` of a chunk's rows to be
    read again, at least one (a round costs more than reading a sixth of its
    rows again from L2: scripts/bench_torch_instancenorm.py); the round's
    blocks are shared evenly among its samples, with no more chunks a sample
    than it has rows for one 8-channel vector a thread; the rows
    of a chunk that do not fit are read again after the barrier. A pure
    function of its arguments."""
    if not (b > 0 and n > 0 and 0 < c <= MAX_CHANNELS and max_blocks > 0):
        raise ValueError(f"no K3 plan for b={b} n={n} c={c} max_blocks={max_blocks}")
    vecs = -(-c // 8)
    row_bytes = 8 * vecs * itemsize * (2 if backward else 1)
    fixed = fixed_smem_bytes(c)
    rows_fit = max(0, (SMEM_LIMIT - fixed) // row_bytes)
    need = -(-n // rows_fit) if rows_fit else max_blocks  # chunks a sample on chip
    min_rows = THREADS // vecs  # rows for one vector a thread
    if need <= MAX_CLUSTER:  # a sample fits one cluster: all samples at once
        per_round = rounds = 0
        chunks = max(need, min(MAX_CLUSTER, -(-n // min_rows)))
    else:  # as many samples a round as keep the rows read again under MAX_STREAMED
        per_round = 1
        while per_round < min(b, max_blocks) and _streamed(n, -(-n // (max_blocks // (per_round + 1))),
                                          rows_fit) <= MAX_STREAMED:
            per_round += 1
        rounds = -(-b // per_round)
        per_round = -(-b // rounds)
        chunks = max(1, min(max_blocks // per_round, -(-n // min_rows)))
    chunk_rows = -(-n // chunks)
    chunks = -(-n // chunk_rows)
    resident = min(chunk_rows, rows_fit)
    regime = "slab" if chunks == 1 else "cluster" if rounds == 0 else "grid"
    if rounds == 0:
        per_round, rounds = b, 1
    return Plan(regime, chunks, chunk_rows, per_round, rounds, resident, per_round * chunks,
                fixed + resident * row_bytes, b * chunks * 2 * c, 2 if regime == "grid" else 0)


# ------------------------------------------------------------------ kernels


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_cuda_library("instancenorm.cu")
    fwd, bwd = lib.corrifnet_in_fwd, lib.corrifnet_in_bwd
    ints = [ctypes.c_int] * 10
    fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] + ints
                    + [ctypes.c_float, ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong] + ints
                    + [ctypes.c_void_p])
    return fwd, bwd


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _max_blocks(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


_BARRIERS = {}


def _barrier(x):
    """The grid barrier's two words on x's device and current stream: 0
    arrivals on entry and on exit (the last block resets them), so launches
    that share them run in order: one pair per stream. Made on the stream,
    so its zeros come before the launch."""
    key = (x.device, _stream(x))
    buf = _BARRIERS.get(key)
    if buf is None:
        buf = torch.zeros(2, dtype=torch.int32, device=x.device)
        _BARRIERS[key] = buf
    return buf


def _check(x, what):
    if x.dim() < 3 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} takes float32 or bfloat16 (B, *spatial, C), "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous channels-last volume")
    if x.shape[-1] > MAX_CHANNELS or x.numel() == 0:
        raise ValueError(f"{what} takes 1 to {MAX_CHANNELS} channels and a non-empty "
                         f"volume, got {tuple(x.shape)}")


def _launch_args(x, backward):
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // (b * c)
    p = plan(b, n, c, x.element_size(), backward, _max_blocks(x.device))
    partials = torch.empty(p.partial_floats, dtype=torch.float32, device=x.device)
    barrier = _barrier(x) if p.barrier_words else None
    vec = int(c % 8 == 0 and x.data_ptr() % 16 == 0)
    return p, partials, barrier, (b, n, c, _DTYPE_CODES[x.dtype], vec, p.chunks, p.per_round,
                                  p.rounds, p.chunk_rows, p.resident_rows,
                                  int(p.regime == "cluster"), p.smem)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(x, eps):
    """Kernel K3 on a CUDA tensor: (y, mean, rstd)."""
    launch = _library()[0]
    _check(x, "relu_instancenorm")
    _, partials, barrier, dims = _launch_args(x, False)
    out = torch.empty_like(x)
    mean = torch.empty((x.shape[0], x.shape[-1]), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    err = launch(_ptr(x), _ptr(out), _ptr(mean), _ptr(rstd), _ptr(partials),
                        _ptr(barrier), *dims, float(eps), _stream(x))
    if err != 0:
        raise RuntimeError(f"relu_instancenorm launch failed: cudaError {err}")
    relu_instancenorm.launches += 1
    return out, mean, rstd


def _launch_bwd(x, g, mean, rstd):
    """Kernel K3b on CUDA tensors: dx."""
    launch = _library()[1]
    _check(x, "relu_instancenorm_bwd")
    stats = (x.shape[0], x.shape[-1])
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g must be {x.dtype} {tuple(x.shape)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if tuple(t.shape) != stats or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {stats}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    g = g.contiguous()
    _, partials, barrier, dims = _launch_args(x, True)
    if dims[4] and g.data_ptr() % 16:
        dims = dims[:4] + (0,) + dims[5:]
    dx = torch.empty_like(x)
    err = launch(_ptr(x), _ptr(g), _ptr(mean), _ptr(rstd), _ptr(dx), _ptr(partials),
                        _ptr(barrier), *dims, _stream(x))
    if err != 0:
        raise RuntimeError(f"relu_instancenorm_bwd launch failed: cudaError {err}")
    relu_instancenorm_bwd.launches += 1
    return dx


def _on_cpu(x):
    if x.device.type not in (*PLAIN_DEVICES, "cuda"):
        raise ValueError(f"no instancenorm kernel for device {x.device}")
    return x.device.type in PLAIN_DEVICES


def relu_instancenorm_bwd(x, g, mean, rstd, eps=1e-5):
    """dx of ``relu_instancenorm`` from the input ``x``, the output gradient
    ``g`` and the forward's statistics ``mean`` and ``rstd`` (f32 ``(B, C)``).
    CPU tensors: the plain formula. CUDA tensors: kernel K3b, or an
    exception."""
    if _on_cpu(x):
        return relu_instancenorm_backward_plain(x, g, eps, mean, rstd)
    return _launch_bwd(x, g, mean, rstd)


class _ReluInstanceNorm(torch.autograd.Function):
    """K3 forward, saving x and its statistics; K3b backward."""

    @staticmethod
    def forward(ctx, x, eps):
        y, mean, rstd = _launch(x, eps)
        ctx.save_for_backward(x, mean, rstd)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        return relu_instancenorm_bwd(x, g, mean, rstd, ctx.eps), None


def relu_instancenorm(x, eps=1e-5):
    """Channels-last (B, *spatial, C) ReLU + InstanceNorm, differentiable.
    CPU tensors: the plain version. CUDA tensors: kernels K3 and K3b, or an
    exception; never the plain versions."""
    if _on_cpu(x):
        return relu_instancenorm_plain(x, eps)
    _library()  # a missing compiler raises here, before autograd is involved
    return _ReluInstanceNorm.apply(x, eps)


relu_instancenorm.launches = 0
relu_instancenorm_bwd.launches = 0
