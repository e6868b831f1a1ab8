"""Fused multi-head attention: ``dropout(softmax(q k^T * scale)) v``.

Counterpart of ``corrifnet_tpu/ops/attention.py`` (``fused_attention`` and
``attention_xla``), forward and backward, with attention-probability
dropout generated inside the kernels. Layout is the JAX one,
``(B, H, N, D)`` heads-major.

Kernel K2f is CUDA C++ (``csrc/attention_fwd.cu``) and replaces the TPU
kernel ``_fwd_kernel`` that ``_fused_fwd`` runs through ``pl.pallas_call``
(``corrifnet_tpu/ops/attention.py:206-230,263-294``); kernel K2b
(``csrc/attention_bwd.cu``) replaces ``_bwd_kernel``, run by
``_fused_bwd_impl`` (``attention.py:300-373,376-409``). Both compute their
matrix products in their own bodies, tiled over 64-row query and key
blocks, so the (N, N) scores, probabilities and their gradients never reach
device memory; the forward leaves one f32 logsumexp per query row for the
backward. The source notes in the ``.cu`` files state what bounds them on
the H100 and how they are laid out.

Dropout: the keep mask is a pure function of ``(seed, offset, batch*head,
query row, key column)`` through Philox4x32-10, computed in the kernels and
never stored. The caller draws ``(seed, offset)`` on the host from an
explicit generator and passes it as ``philox``. ``philox_keep_mask`` is the
same function written with integer tensor ops: it is what the CPU path
uses, so a CPU run and a GPU run with one key drop the same entries, and
what ``attention_plain`` is given when a kernel is checked with dropout on.
The bits are not the TPU generator's; only the distribution is shared.

``fused_attention`` is differentiable (a ``torch.autograd.Function`` around
the two kernels). It takes the plain version below only for tensors on the
CPU; for CUDA tensors the forward and the backward launch their kernels or
raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from corrifnet_tpu_torch.ops.build import load_cuda_library

__all__ = ["attention_plain", "fused_attention", "fused_attention_bwd",
           "kernel_keep_mask", "philox_keep_mask"]

HEAD_DIM = 64
TILE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def attention_plain(q, k, v, scale, rate=0.0, keep=None):
    """Plain PyTorch version: f32 scores and softmax, output in q's dtype.
    With ``rate > 0``, ``keep`` (bool, broadcastable to (B, H, N, N)) marks
    the probabilities that survive; they are scaled by 1/(1-rate) after the
    softmax, so the normalizer is the undropped row sum."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        if keep is None:
            raise ValueError("attention_plain with rate > 0 needs a keep mask")
        p = torch.where(keep, p * _inv_keep(rate), torch.zeros_like(p))
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


def _threshold(rate: float) -> int:
    """A 32-bit word keeps its entry when it is >= rate * 2^32."""
    return min(int(rate * 4294967296.0), _MASK32)


def _inv_keep(rate: float) -> float:
    """1 / (1 - rate) as the f32 value the kernels are given."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()


def _mulhilo(m: int, x):
    """(high, low) 32-bit halves of m * x for int64 tensors holding 32-bit
    words; split in 16-bit limbs so that no product leaves int64."""
    t = (x & 0xFFFF) * m
    u = (x >> 16) * m
    low = ((u & 0xFFFF) << 16) + (t & _MASK32)
    high = (u >> 16) + (t >> 32) + (low >> 32)
    return high & _MASK32, low & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors that hold 32-bit words: ``counter`` is
    four tensors of one shape, ``key`` two Python ints; returns four words."""
    c0, c1, c2, c3 = counter
    k0, k1 = (int(w) & _MASK32 for w in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def philox_keep_mask(seed, offset, bh, n, rate, device="cpu", bh0=0):
    """The kernels' keep mask in plain PyTorch, bit for bit: bool
    ``(bh, n, n)`` for batch*head rows ``bh0 .. bh0+bh-1``. Key (seed,
    offset), counter (column / 4, row, batch*head, 0); word j of a call
    decides column 4*(column/4) + j, kept when word >= rate * 2^32."""
    if n % 4 != 0:
        raise ValueError(f"n must be a multiple of 4, got {n}")
    i64 = dict(dtype=torch.int64, device=device)
    shape = (bh, n, n // 4)
    groups = torch.arange(n // 4, **i64).view(1, 1, -1).expand(shape)
    rows = torch.arange(n, **i64).view(1, -1, 1).expand(shape)
    heads = torch.arange(bh0, bh0 + bh, **i64).view(-1, 1, 1).expand(shape)
    words = philox4x32_10((groups, rows, heads, torch.zeros(shape, **i64)),
                          (seed, offset))
    return (torch.stack(words, dim=-1) >= _threshold(rate)).reshape(bh, n, n)


@functools.lru_cache(maxsize=None)
def _forward_library():
    lib = load_cuda_library("attention_fwd.cu")
    fwd = lib.corrifnet_attention_fwd
    fwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
        ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ]
    fwd.restype = ctypes.c_int
    mask = lib.corrifnet_attention_keep_mask
    mask.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    mask.restype = ctypes.c_int
    return fwd, mask


@functools.lru_cache(maxsize=None)
def _backward_library():
    fn = load_cuda_library("attention_bwd.cu").corrifnet_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
        ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(*tensors):
    q = tensors[0]
    shapes = [tuple(t.shape) for t in tensors]
    if len(set(shapes)) != 1 or q.dim() != 4:
        raise ValueError(f"operands must share one (B, H, N, D) shape: {shapes}")
    b, h, n, d = q.shape
    if d != HEAD_DIM or n % TILE != 0:
        raise ValueError(f"kernel takes head_dim {HEAD_DIM} and N a multiple "
                         f"of {TILE}: got N={n}, D={d}")
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got "
                         f"{[t.dtype for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel takes contiguous operands")


def _philox_words(rate, philox):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and philox is None:
        raise ValueError("dropout needs philox=(seed, offset)")
    seed, offset = (int(w) & _MASK32 for w in (philox or (0, 0)))
    return seed, offset


def _launch_fwd(q, k, v, scale, rate, seed, offset, with_lse):
    """Kernel K2f on CUDA tensors: (out, lse or None)."""
    _check(q, k, v)
    launch, _ = _forward_library()
    b, h, n, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b * h, n, _DTYPE_CODES[q.dtype],
        float(scale), _threshold(rate), _inv_keep(rate), seed, offset,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out, lse


def fused_attention_bwd(q, k, v, out, lse, d_out, scale, rate=0.0, philox=None):
    """(dq, dk, dv) of ``fused_attention`` from its inputs, its output, its
    logsumexp ``lse`` (B, H, N) and the output gradient. CPU tensors: autograd
    through the plain version. CUDA tensors: kernel K2b (its delta, dq and
    dk/dv passes count as one launch), or an exception; never the plain
    version."""
    seed, offset = _philox_words(rate, philox)
    if q.device.type == "cpu":
        b, h, n, _ = q.shape
        keep = (philox_keep_mask(seed, offset, b * h, n, rate).view(b, h, n, n)
                if rate > 0.0 else None)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = attention_plain(*leaves, scale, rate, keep)
        return torch.autograd.grad(o, leaves, d_out)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v, out, d_out)
    b, h, n, _ = q.shape
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 (B, H, N), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    launch = _backward_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(lse)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, n, _DTYPE_CODES[q.dtype],
        float(scale), _threshold(rate), _inv_keep(rate), seed, offset,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed: cudaError {err}")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """K2f forward (with the lse residual), K2b backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rate, seed, offset):
        needs_grad = any(ctx.needs_input_grad[:3])
        out, lse = _launch_fwd(q, k, v, scale, rate, seed, offset, needs_grad)
        if needs_grad:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, rate, (seed, offset))
        return out

    @staticmethod
    def backward(ctx, d_out):
        scale, rate, philox = ctx.args
        dq, dk, dv = fused_attention_bwd(*ctx.saved_tensors, d_out.contiguous(),
                                         scale, rate, philox)
        return dq, dk, dv, None, None, None, None


def fused_attention(q, k, v, scale, rate=0.0, philox=None):
    """(B, H, N, D) attention, differentiable, with probability dropout at
    ``rate`` keyed by ``philox=(seed, offset)``. CPU tensors: the plain
    version with ``philox_keep_mask``. CUDA tensors: kernel K2f, and K2b in
    the backward, or an exception; never the plain version."""
    seed, offset = _philox_words(rate, philox)
    if q.device.type == "cpu":
        keep = None
        if rate > 0.0:
            b, h, n, _ = q.shape
            keep = philox_keep_mask(seed, offset, b * h, n, rate).view(b, h, n, n)
        return attention_plain(q, k, v, scale, rate, keep)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v)
    _forward_library()  # a failed build raises here, before autograd is involved
    return _FusedAttention.apply(q, k, v, float(scale), float(rate), seed, offset)


def kernel_keep_mask(seed, offset, bh0, count, n, rate, device="cuda"):
    """The keep mask as the kernels' own device function writes it: bool
    ``(count, n, n)`` for batch*head rows ``bh0 .. bh0+count-1``. For the
    GPU checks against ``philox_keep_mask``; nothing on the model's path
    stores a mask."""
    if n % TILE != 0:
        raise ValueError(f"n must be a multiple of {TILE}, got {n}")
    _, launch = _forward_library()
    out = torch.empty((count, n, n), dtype=torch.uint8, device=device)
    err = launch(out.data_ptr(), bh0, count, n, _threshold(rate),
                 int(seed) & _MASK32, int(offset) & _MASK32,
                 torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention keep-mask launch failed: cudaError {err}")
    return out.bool()


fused_attention.launches = 0
fused_attention_bwd.launches = 0
