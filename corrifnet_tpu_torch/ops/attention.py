"""Fused multi-head attention forward: ``softmax(q k^T * scale) v``.

Counterpart of ``corrifnet_tpu/ops/attention.py`` (``fused_attention`` and
``attention_xla``) on the inference path: dropout rate 0 and no logsumexp
residual. Layout is the JAX one, ``(B, H, N, D)`` heads-major.

Kernel K2 is CUDA C++ (``csrc/attention_fwd.cu``) and replaces the TPU
kernel ``_fwd_kernel`` that ``_fused_fwd`` runs through ``pl.pallas_call``
(``corrifnet_tpu/ops/attention.py:206-230,263-294``). It computes both
matrix products in its own body, as the TPU kernel does: tiled over
64-row query blocks and 64-row K/V blocks with an online f32 softmax, so
the (N, N) scores never reach device memory. The source note in the
``.cu`` file states what bounds it on the H100 and how it is laid out.

``fused_attention`` takes the plain version below only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from corrifnet_tpu_torch.ops.build import load_cuda_library

__all__ = ["attention_plain", "fused_attention"]

HEAD_DIM = 64
TILE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q, k, v, scale):
    """Plain PyTorch version: f32 scores and softmax, output in q's dtype."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_cuda_library("attention_fwd.cu")
    fn = lib.corrifnet_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, d = q.shape
    if d != HEAD_DIM or n % TILE != 0:
        raise ValueError(f"kernel takes head_dim {HEAD_DIM} and N a multiple "
                         f"of {TILE}: got N={n}, D={d}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("kernel takes contiguous q, k, v")


def fused_attention(q, k, v, scale):
    """(B, H, N, D) attention. CPU tensors: the plain version. CUDA tensors:
    kernel K2, or an exception; never the plain version."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v)
    launch = _library()
    b, h, n, _ = q.shape
    out = torch.empty_like(q)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n,
        _DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
