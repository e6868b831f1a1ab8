"""Correlation-aware inter-modality fusion, CorrIFNet's own op.

Counterpart of ``corrifnet_tpu/ops/correlation.py`` (``correlation_fusion``
and ``correlation_fusion_xla``). For each output modality ``m`` and each
element, independently:

    out[m] = sum_i softmax_i(q[m] * k[i] / sqrt(3)) * v[i]

over stacked modality tensors ``(3, B, N, C)``. The per-element semantics
are kept, not the reference's batch scramble at B > 1 (see the JAX module).

Both kernels are Triton. K1f replaces the TPU kernel ``_fwd_kernel`` and
K1b the TPU kernel ``_bwd_kernel``, which ``_row_blocked_call`` runs through
``pl.pallas_call`` (``corrifnet_tpu/ops/correlation.py:59-71,74-107,114-130``).
Per element the forward reads 9 values, does a 3-way softmax for each of 3
outputs and writes 3 values; the backward reads 12 (q, k, v and the output
gradient g), recomputes the 3x3 weights and writes 9 (dq, dk, dv), with dk
and dv summed over the three output modalities in registers. There is no
data reuse and no reduction across elements, so both are bound by
device-memory bandwidth (at the training shape (3, 4*512, 512) in bf16 the
forward moves 25 MB and the backward 44 MB). Design: a 1-D grid of
contiguous element blocks; each program loads k and v of all three
modalities once, then q[m] (and g[m]) per output, computes in f32 and
rounds once at each store. Nothing but the operands and the results crosses
memory: the attention weights are never stored for the backward.

``correlation_fusion`` is differentiable (a ``torch.autograd.Function``
around the two kernels). It takes the plain versions below only for tensors
on the CPU; for CUDA tensors the forward and the backward launch their
kernels or raise.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["correlation_fusion", "correlation_fusion_backward_plain",
           "correlation_fusion_bwd", "correlation_fusion_plain"]

_INV_SQRT3 = 1.0 / (3.0 ** 0.5)
_BLOCK = 1024


def correlation_fusion_plain(q, k, v):
    """Plain PyTorch version: f32 inside, output in q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = qf[:, None] * kf[None, :] * _INV_SQRT3  # (3 out m, 3 in i, B, N, C)
    a = torch.softmax(s, dim=1)
    return (a * vf[None, :]).sum(dim=1).to(q.dtype)


def correlation_fusion_backward_plain(q, k, v, g):
    """Plain PyTorch version of the backward: (dq, dk, dv) by the formulas
    of the TPU kernel (``corrifnet_tpu/ops/correlation.py:77-81``), f32
    inside, results in q's dtype."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    a = torch.softmax(qf[:, None] * kf[None, :] * _INV_SQRT3, dim=1)  # (m, i, ...)
    out = (a * vf[None, :]).sum(dim=1)
    ds = a * gf[:, None] * (vf[None, :] - out[:, None])
    dq = (ds * kf[None, :]).sum(dim=1) * _INV_SQRT3
    dk = (ds * qf[:, None]).sum(dim=0) * _INV_SQRT3
    dv = (a * gf[:, None]).sum(dim=0)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Compiled on first use: triton exists only where there is a GPU."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def corr_fwd(q_ptr, k_ptr, v_ptr, o_ptr, M, inv_sqrt3,
                 BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < M
        k0 = tl.load(k_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        k1 = tl.load(k_ptr + M + offs, mask=mask, other=0.0).to(tl.float32)
        k2 = tl.load(k_ptr + 2 * M + offs, mask=mask, other=0.0).to(tl.float32)
        v0 = tl.load(v_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v1 = tl.load(v_ptr + M + offs, mask=mask, other=0.0).to(tl.float32)
        v2 = tl.load(v_ptr + 2 * M + offs, mask=mask, other=0.0).to(tl.float32)
        for m in tl.static_range(3):
            qm = tl.load(q_ptr + m * M + offs, mask=mask, other=0.0).to(tl.float32)
            s0 = qm * k0 * inv_sqrt3
            s1 = qm * k1 * inv_sqrt3
            s2 = qm * k2 * inv_sqrt3
            mx = tl.maximum(tl.maximum(s0, s1), s2)
            e0 = tl.exp(s0 - mx)
            e1 = tl.exp(s1 - mx)
            e2 = tl.exp(s2 - mx)
            out = (e0 * v0 + e1 * v1 + e2 * v2) / (e0 + e1 + e2)
            tl.store(o_ptr + m * M + offs, out.to(o_ptr.dtype.element_ty),
                     mask=mask)

    return corr_fwd


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """Compiled on first use: triton exists only where there is a GPU."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def corr_bwd(q_ptr, k_ptr, v_ptr, g_ptr, dq_ptr, dk_ptr, dv_ptr, M,
                 inv_sqrt3, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < M
        k0 = tl.load(k_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        k1 = tl.load(k_ptr + M + offs, mask=mask, other=0.0).to(tl.float32)
        k2 = tl.load(k_ptr + 2 * M + offs, mask=mask, other=0.0).to(tl.float32)
        v0 = tl.load(v_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v1 = tl.load(v_ptr + M + offs, mask=mask, other=0.0).to(tl.float32)
        v2 = tl.load(v_ptr + 2 * M + offs, mask=mask, other=0.0).to(tl.float32)
        dk0 = tl.zeros([BLOCK], dtype=tl.float32)
        dk1 = tl.zeros([BLOCK], dtype=tl.float32)
        dk2 = tl.zeros([BLOCK], dtype=tl.float32)
        dv0 = tl.zeros([BLOCK], dtype=tl.float32)
        dv1 = tl.zeros([BLOCK], dtype=tl.float32)
        dv2 = tl.zeros([BLOCK], dtype=tl.float32)
        for m in tl.static_range(3):
            qm = tl.load(q_ptr + m * M + offs, mask=mask, other=0.0).to(tl.float32)
            gm = tl.load(g_ptr + m * M + offs, mask=mask, other=0.0).to(tl.float32)
            s0 = qm * k0 * inv_sqrt3
            s1 = qm * k1 * inv_sqrt3
            s2 = qm * k2 * inv_sqrt3
            mx = tl.maximum(tl.maximum(s0, s1), s2)
            e0 = tl.exp(s0 - mx)
            e1 = tl.exp(s1 - mx)
            e2 = tl.exp(s2 - mx)
            den = e0 + e1 + e2
            a0 = e0 / den
            a1 = e1 / den
            a2 = e2 / den
            out = a0 * v0 + a1 * v1 + a2 * v2
            ds0 = a0 * gm * (v0 - out)
            ds1 = a1 * gm * (v1 - out)
            ds2 = a2 * gm * (v2 - out)
            dq = (ds0 * k0 + ds1 * k1 + ds2 * k2) * inv_sqrt3
            tl.store(dq_ptr + m * M + offs, dq.to(dq_ptr.dtype.element_ty),
                     mask=mask)
            dk0 += ds0 * qm * inv_sqrt3
            dk1 += ds1 * qm * inv_sqrt3
            dk2 += ds2 * qm * inv_sqrt3
            dv0 += a0 * gm
            dv1 += a1 * gm
            dv2 += a2 * gm
        tl.store(dk_ptr + offs, dk0.to(dk_ptr.dtype.element_ty), mask=mask)
        tl.store(dk_ptr + M + offs, dk1.to(dk_ptr.dtype.element_ty), mask=mask)
        tl.store(dk_ptr + 2 * M + offs, dk2.to(dk_ptr.dtype.element_ty), mask=mask)
        tl.store(dv_ptr + offs, dv0.to(dv_ptr.dtype.element_ty), mask=mask)
        tl.store(dv_ptr + M + offs, dv1.to(dv_ptr.dtype.element_ty), mask=mask)
        tl.store(dv_ptr + 2 * M + offs, dv2.to(dv_ptr.dtype.element_ty), mask=mask)

    return corr_bwd


def _check(*tensors):
    q = tensors[0]
    shapes = [tuple(t.shape) for t in tensors]
    if len(set(shapes)) != 1 or q.dim() != 4 or q.shape[0] != 3:
        raise ValueError(f"operands must share one (3, B, N, C) shape: {shapes}")
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise ValueError(f"kernel takes float32 or bfloat16, got "
                         f"{[t.dtype for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel takes contiguous operands")


def _launch_fwd(q, k, v):
    """Kernel K1f on CUDA tensors."""
    _check(q, k, v)
    kernel = _kernel()
    out = torch.empty_like(q)
    m = q[0].numel()
    kernel[(-(-m // _BLOCK),)](q, k, v, out, m, _INV_SQRT3, BLOCK=_BLOCK,
                               num_warps=4)
    correlation_fusion.launches += 1
    return out


def correlation_fusion_bwd(q, k, v, g):
    """(dq, dk, dv) of ``correlation_fusion`` for the output gradient ``g``.
    CPU tensors: the plain version. CUDA tensors: kernel K1b, or an
    exception; never the plain version."""
    if q.device.type == "cpu":
        return correlation_fusion_backward_plain(q, k, v, g)
    if q.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {q.device}")
    _check(q, k, v, g)
    kernel = _bwd_kernel()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    m = q[0].numel()
    kernel[(-(-m // _BLOCK),)](q, k, v, g, dq, dk, dv, m, _INV_SQRT3,
                               BLOCK=_BLOCK, num_warps=4)
    correlation_fusion_bwd.launches += 1
    return dq, dk, dv


class _CorrelationFusion(torch.autograd.Function):
    """K1f forward, K1b backward; q, k, v are saved and the weights
    recomputed, as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return correlation_fusion_bwd(*ctx.saved_tensors, g.contiguous())


def correlation_fusion(q, k, v):
    """(3, B, N, C) correlation fusion, differentiable. CPU tensors: the
    plain version (and autograd through it). CUDA tensors: kernel K1f, and
    K1b in the backward, or an exception; never the plain version."""
    if q.device.type == "cpu":
        return correlation_fusion_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {q.device}")
    _check(q, k, v)
    _kernel()  # a missing compiler raises here, before autograd is involved
    return _CorrelationFusion.apply(q, k, v)


correlation_fusion.launches = 0
correlation_fusion_bwd.launches = 0
