"""Correlation-aware inter-modality fusion, CorrIFNet's own op.

Counterpart of ``corrifnet_tpu/ops/correlation.py`` (``correlation_fusion``
and ``correlation_fusion_xla``). For each output modality ``m`` and each
element, independently:

    out[m] = sum_i softmax_i(q[m] * k[i] / sqrt(3)) * v[i]

over stacked modality tensors ``(3, B, N, C)``. The per-element semantics
are kept, not the reference's batch scramble at B > 1 (see the JAX module).

Kernel K1 is Triton and replaces the TPU kernel ``_fwd_kernel`` that
``_row_blocked_call`` runs through ``pl.pallas_call``
(``corrifnet_tpu/ops/correlation.py:59-71,114-130``). Per element it reads 9
values, does a 3-way softmax for each of 3 outputs and writes 3 values:
no data reuse, so it is bound by device-memory bandwidth (at the model's
(3, 8*512, 512) bf16 operands, 38 MB read and 13 MB written). Design: a 1-D
grid of contiguous element blocks; each program loads k and v of all
three modalities once, then q[m] per output, computes in f32 and stores in
the input dtype. Nothing but the operands and the output crosses memory.

``correlation_fusion`` takes the plain version below only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["correlation_fusion", "correlation_fusion_plain"]

_INV_SQRT3 = 1.0 / (3.0 ** 0.5)
_BLOCK = 1024


def correlation_fusion_plain(q, k, v):
    """Plain PyTorch version: f32 inside, output in q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = qf[:, None] * kf[None, :] * _INV_SQRT3  # (3 out m, 3 in i, B, N, C)
    a = torch.softmax(s, dim=1)
    return (a * vf[None, :]).sum(dim=1).to(q.dtype)


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


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4 or q.shape[0] != 3:
        raise ValueError(f"q, k, v must share one (3, B, N, C) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise ValueError(f"kernel takes float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("kernel takes contiguous q, k, v")


def correlation_fusion(q, k, v):
    """(3, B, N, C) correlation fusion. CPU tensors: the plain version. CUDA
    tensors: kernel K1, or an exception; never the plain version."""
    if q.device.type == "cpu":
        return correlation_fusion_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {q.device}")
    _check(q, k, v)
    kernel = _kernel()
    out = torch.empty_like(q)
    m = q[0].numel()
    kernel[(-(-m // _BLOCK),)](q, k, v, out, m, _INV_SQRT3, BLOCK=_BLOCK,
                               num_warps=4)
    correlation_fusion.launches += 1
    return out


correlation_fusion.launches = 0
