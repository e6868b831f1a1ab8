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
matrix products in their own bodies, tiled over query and key blocks, so
the (N, N) scores, probabilities and their gradients never reach device
memory; the forward leaves one f32 logsumexp per query row for the
backward. The source notes in the ``.cu`` files state what bounds them on
the H100 and how they are laid out.

Dispatch on dtype: bfloat16 operands, the model's working type, launch the
tensor-core kernels (``wgmma`` with bf16 operands and f32 accumulators; p
and ds are rounded to bf16 between the two products, as the TPU kernel
rounds them); float32 operands launch the f32 FMA kernels, which are what
the f32 model is held to the CPU with. Neither is a fallback for the other:
a CUDA tensor launches the kernel of its dtype or raises.

Operands may be strided views: batch, head and row strides are free, the
last dimension is contiguous and every row starts on a 16-byte boundary.
``fused_attention_qkv`` takes the ``(B, N, 3, H, D)`` product of the qkv
projection as it is, reads q, k and v in place, writes the output as
``(B, N, H, D)`` memory (returned as its ``(B, H, N, D)`` view) and the
gradient into one ``(B, N, 3, H, D)`` buffer, so no layout copy is made on
either side of the kernels.

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

__all__ = ["attention_backward_plain", "attention_plain", "fused_attention",
           "fused_attention_bwd", "fused_attention_qkv", "kernel_keep_mask",
           "philox_keep_mask"]

HEAD_DIM = 64
TILE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def attention_plain(q, k, v, scale, rate=0.0, keep=None, kernel_rounding=False):
    """Plain PyTorch version: f32 scores and softmax, output in q's dtype.
    With ``rate > 0``, ``keep`` (bool, broadcastable to (B, H, N, N)) marks
    the probabilities that survive; they are scaled by 1/(1-rate) after the
    softmax, so the normalizer is the undropped row sum.

    ``kernel_rounding`` rounds where the bf16 kernel rounds: the
    unnormalised ``exp(s - max) * keep / (1 - rate)`` goes to v's dtype before
    the product with v, and the f32 row sum of the unrounded exponentials
    divides afterwards. (The kernel's maximum is a running one, so its
    rounded values differ from these by an ulp here and there.)"""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if rate > 0.0 and keep is None:
        raise ValueError("attention_plain with rate > 0 needs a keep mask")
    if kernel_rounding:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        total = e.sum(dim=-1, keepdim=True)
        if rate > 0.0:
            e = torch.where(keep, e * _inv_keep(rate), torch.zeros_like(e))
        e = e.to(v.dtype).float()
        return (torch.einsum("bhnm,bhmd->bhnd", e, v.float()) / total).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = torch.where(keep, p * _inv_keep(rate), torch.zeros_like(p))
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


def attention_backward_plain(q, k, v, out, lse, d_out, scale, rate=0.0, keep=None,
                             kernel_rounding=False):
    """(dq, dk, dv) by the formulas kernel K2b computes, in plain PyTorch:
    ``p = exp(s * scale - lse)``, ``m = keep / (1 - rate)``, ``dv = (p m)^T
    dO``, ``ds = p (dO v^T m - delta)`` with ``delta = sum(dO o)``, ``dq =
    scale ds k``, ``dk = scale ds^T q``; f32 throughout, results in q's dtype.
    ``lse`` None recomputes the logsumexp. ``kernel_rounding`` rounds ``p m``
    and ``ds`` to q's dtype before their products, as the bf16 kernel does."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, d_out))
    s = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.einsum("bhnd,bhmd->bhnm", gf, vf)
    pm = p
    if rate > 0.0:
        if keep is None:
            raise ValueError("attention_backward_plain with rate > 0 needs a keep mask")
        pm = torch.where(keep, p * _inv_keep(rate), torch.zeros_like(p))
        dp = torch.where(keep, dp * _inv_keep(rate), torch.zeros_like(dp))
    ds = p * (dp - (gf * of).sum(dim=-1, keepdim=True))
    if kernel_rounding:
        pm, ds = pm.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, qf) * scale
    dv = torch.einsum("bhnm,bhnd->bhmd", pm, gf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _threshold(rate: float) -> int:
    """A 32-bit word keeps its entry when it is >= rate * 2^32."""
    return min(int(rate * 4294967296.0), _MASK32)


@functools.lru_cache(maxsize=None)
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
    fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_uint, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ]
    fwd.restype = ctypes.c_int
    mask = lib.corrifnet_attention_keep_mask
    mask.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                     ctypes.c_void_p]
    mask.restype = ctypes.c_int
    return fwd, mask


@functools.lru_cache(maxsize=None)
def _backward_library():
    fn = load_cuda_library("attention_bwd.cu").corrifnet_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_uint, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _kernel_layout(t):
    """Whether the kernels can read ``t`` in place: last dimension
    contiguous, every row on a 16-byte boundary."""
    per16 = 16 // t.element_size()
    st = t.stride()
    return (st[-1] == 1 and t.data_ptr() % 16 == 0
            and not any(step % per16 for step in st[:-1]))


def _check(*tensors):
    q = tensors[0]
    shape, dtype, device = q.shape, q.dtype, q.device
    if q.dim() != 4 or any(t.shape != shape for t in tensors):
        raise ValueError("operands must share one (B, H, N, D) shape: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if shape[3] != HEAD_DIM or shape[2] % TILE != 0:
        raise ValueError(f"kernel takes head_dim {HEAD_DIM} and N a multiple "
                         f"of {TILE}: got N={shape[2]}, D={shape[3]}")
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise ValueError(f"kernel takes float32 or bfloat16, got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != device for t in tensors):
        raise ValueError("operands must be on one device")
    if not all(_kernel_layout(t) for t in tensors):
        raise ValueError(
            "kernel takes operands whose last dimension is contiguous and whose "
            f"rows are 16-byte aligned, got strides {[t.stride() for t in tensors]}")


@functools.lru_cache(maxsize=256)
def _stride_array(flat):
    return (ctypes.c_longlong * len(flat))(*flat)


def _strides(*tensors, more=()):
    """The (batch, head, row) element strides of each tensor, then ``more``,
    as the C interface takes them (it reads them during the call, so one
    array serves every call with these strides)."""
    return _stride_array(tuple(step for t in tensors for step in t.stride()[:3]) + more)


def _philox_words(rate, philox):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and philox is None:
        raise ValueError("dropout needs philox=(seed, offset)")
    seed, offset = (int(w) & _MASK32 for w in (philox or (0, 0)))
    return seed, offset


def _launch_fwd(q, k, v, scale, rate, seed, offset, with_lse):
    """Kernel K2f on CUDA tensors that ``_check`` has passed: (out, lse or
    None). ``out`` is the (B, H, N, D) view of (B, N, H, D) memory, the
    layout the output projection reads."""
    launch, _ = _forward_library()
    b, h, n, d = q.shape
    out = torch.empty_strided((b, h, n, d), (n * h * d, d, h * d, 1), dtype=q.dtype,
                              device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, _strides(q, k, v, out), b, h, n,
        _DTYPE_CODES[q.dtype], scale, _threshold(rate), _inv_keep(rate),
        seed, offset, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, d_out, scale, rate, seed, offset):
    """Kernel K2b on CUDA tensors that ``_check`` has passed: the gradient
    as one (B, N, 3, H, D) buffer, the layout of the qkv projection's output
    (dq, dk, dv are its ``_unpack`` views)."""
    launch = _backward_library()
    b, h, n, d = q.shape
    dqkv = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty_like(lse)
    base, step = dqkv.data_ptr(), h * d * dqkv.element_size()
    grad_strides = (n * 3 * h * d, d, 3 * h * d) * 3  # of dq, dk, dv inside dqkv
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), base, base + step,
        base + 2 * step, _strides(q, k, v, out, d_out, more=grad_strides), b, h, n,
        _DTYPE_CODES[q.dtype], scale, _threshold(rate), _inv_keep(rate), seed, offset,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed: cudaError {err}")
    fused_attention_bwd.launches += 1
    return dqkv


def _unpack(qkv):
    """The (B, H, N, D) views q, k, v of a (B, N, 3, H, D) tensor."""
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def fused_attention_bwd(q, k, v, out, lse, d_out, scale, rate=0.0, philox=None):
    """(dq, dk, dv) of ``fused_attention`` from its inputs, its output, its
    logsumexp ``lse`` (B, H, N) and the output gradient. CPU tensors: autograd
    through the plain version. CUDA tensors: kernel K2b (its passes count as
    one launch), or an exception; never the plain version. On the card the
    three are views of one (B, N, 3, H, D) buffer."""
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
    if (lse.shape != out.shape[:3] or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 (B, H, N), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    return _unpack(_launch_bwd(q, k, v, out, lse, d_out, float(scale), rate, seed, offset))


def _cotangent(d_out):
    """The output gradient as the kernel can read it: in place where its
    layout allows (the output projection's backward gives (B, N, H, D)
    memory), else one contiguous copy."""
    return d_out if _kernel_layout(d_out) else d_out.contiguous()


class _FusedAttention(torch.autograd.Function):
    """K2f forward (with the lse residual), K2b backward. ``source`` is q, k
    and v, or the one packed (B, N, 3, H, D) tensor they are views of; the
    gradient comes back in the same form."""

    @staticmethod
    def forward(ctx, *args):
        *source, scale, rate, seed, offset = args
        ctx.args = (scale, rate, (seed, offset))
        ctx.packed = len(source) == 1
        needs_grad = any(ctx.needs_input_grad[:len(source)])
        q, k, v = _unpack(source[0]) if ctx.packed else source
        out, lse = _launch_fwd(q, k, v, scale, rate, seed, offset, needs_grad)
        if needs_grad:
            ctx.save_for_backward(*source, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        scale, rate, philox = ctx.args
        *source, out, lse = ctx.saved_tensors
        q, k, v = _unpack(source[0]) if ctx.packed else source
        dqkv = _launch_bwd(q, k, v, out, lse, _cotangent(d_out), scale, rate, *philox)
        return (*((dqkv,) if ctx.packed else _unpack(dqkv)), None, None, None, None)


def _launch(source, q, k, v, scale, rate, philox):
    """The CUDA path of both public entries: ``source`` as in
    ``_FusedAttention``, q, k and v its (B, H, N, D) views."""
    seed, offset = _philox_words(rate, philox)
    _check(q, k, v)
    _forward_library()  # a failed build raises here, before autograd is involved
    args = (float(scale), float(rate), seed, offset)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in source)):
        return _launch_fwd(q, k, v, *args, False)[0]
    return _FusedAttention.apply(*source, *args)


def fused_attention(q, k, v, scale, rate=0.0, philox=None):
    """(B, H, N, D) attention, differentiable, with probability dropout at
    ``rate`` keyed by ``philox=(seed, offset)``. CPU tensors: the plain
    version with ``philox_keep_mask``. CUDA tensors: kernel K2f, and K2b in
    the backward, or an exception; never the plain version."""
    if q.device.type == "cpu":
        seed, offset = _philox_words(rate, philox)
        keep = None
        if rate > 0.0:
            b, h, n, _ = q.shape
            keep = philox_keep_mask(seed, offset, b * h, n, rate).view(b, h, n, n)
        return attention_plain(q, k, v, scale, rate, keep)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch((q, k, v), q, k, v, scale, rate, philox)


def fused_attention_qkv(qkv, scale, rate=0.0, philox=None):
    """``fused_attention`` on the packed ``(B, N, 3, H, D)`` output of the
    qkv projection; returns ``(B, H, N, D)``. On the card q, k and v are read
    in place, the output is a view of ``(B, N, H, D)`` memory and the
    gradient arrives as one ``(B, N, 3, H, D)`` tensor: no layout copies."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, D), got {tuple(qkv.shape)}")
    if qkv.device.type != "cuda":
        return fused_attention(*_unpack(qkv), scale, rate, philox)
    return _launch((qkv,), *_unpack(qkv), scale, rate, philox)


_MASK_LAYOUTS = {"tile": 0, "rows": 1, "cols": 2}


def kernel_keep_mask(seed, offset, bh0, count, n, rate, device="cuda", layout="tile"):
    """The keep mask as the kernels' own device functions write it: bool
    ``(count, n, n)`` for batch*head rows ``bh0 .. bh0+count-1``. ``layout``
    picks the function: "tile" (the f32 kernels' shared byte tile), "rows"
    (the bf16 forward's and dq pass's register bits) or "cols" (the bf16
    dk/dv pass's 16-bit words). For the GPU checks against
    ``philox_keep_mask``; nothing on the model's path stores a mask."""
    if n % TILE != 0:
        raise ValueError(f"n must be a multiple of {TILE}, got {n}")
    _, launch = _forward_library()
    out = torch.empty((count, n, n), dtype=torch.uint8, device=device)
    err = launch(out.data_ptr(), bh0, count, n, _threshold(rate),
                 int(seed) & _MASK32, int(offset) & _MASK32, _MASK_LAYOUTS[layout],
                 torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention keep-mask launch failed: cudaError {err}")
    return out.bool()


fused_attention.launches = 0
fused_attention_bwd.launches = 0
