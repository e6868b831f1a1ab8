"""Exact depth fusion of the full-depth decoder's resize-then-conv pairs.

Counterpart of ``corrifnet_tpu/nn/depthfuse.py``. The decoder up-samples
its running state x2 in depth (trilinear, align_corners=True) into a
replicate-padded 3^3 conv, and resizes each skip (3 rows deep in MMVit4; 3,
2, 1 or 1 in MMVit2) to the running depth (nearest) before the concat conv.
Both depth resizes are linear maps R, and the conv's three depth taps read
rows clamp(d + t - 1) of the resized volume, so

    y[d] = sum_t W_t (*) (R z)[clamp(d + t - 1)] = sum_{t,k} M[d,t,k] (W_t (*) z[k])

with the static table ``M[d,t,:] = R[clamp(d + t - 1), :]``: one 2-D conv at
the COARSE depth with the three taps concatenated on the output channels,
then one depth expansion. The fine-depth input volume is never built; the
conv runs at half the rows (``linear``) or at the skip's own rows
(``nearest``). Same function as resize-then-conv up to f32 reassociation.

The skip-concat conv's other block, the running state already at the fine
depth, is an ordinary replicate-padded 3^3 conv; as in the JAX package
(``Conv._depth3_shift_add``) it runs as a 2-D conv over its rows with the
taps on the output channels, and its shift-add is the same expansion with
the identity resize. No 3-D conv or 3-D padding is left in the fused chain.

Layout. Inputs and outputs are NCDHW tensors whose memory is channels-last
``(B, D, H, W, C)``, which is what K3 reads. The 2-D convs run on
channels-last images, their taps are regrouped once on the coarse side
(``(B, S, 3, H, W, CO)``, all blocks in one buffer), and the expansion is
one batched product over (block, k, t) that writes the output once,
channels-last, with the bias as its addend.

The tables are built in float64 from the JAX package's rules (the port's
own copies of its ``_linear_matrix``, in ``nn/resize.py``, and
``_nearest_matrix``, below) and cast to the compute dtype where they are
used, as the JAX module casts them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from corrifnet_tpu_torch.nn.resize import _linear_matrix

__all__ = ["coarse_input", "depth_expand", "expand_conv", "fused_resize_conv",
           "tap_expand_table"]


@functools.lru_cache(maxsize=None)
def _nearest_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) one-hot nearest matrix, source index
    ``min(floor(j * (src / dst)), src - 1)`` in float64 (the JAX package's
    rule). PyTorch's float32 rule gives the same rows wherever src / dst is
    exact in float32, as for every skip depth the decoders give it: 3 (all of
    MMVit4's skips, MMVit2's x1), 2 (MMVit2's x2) and 1 (its x3, x4) to
    16..128."""
    idx = np.minimum(np.floor(np.arange(dst) * (src / dst)).astype(np.int64), src - 1)
    w = np.zeros((dst, src), dtype=np.float64)
    w[np.arange(dst), idx] = 1.0
    return w


@functools.lru_cache(maxsize=None)
def tap_expand_table(kind: str, src_d: int, dst_d: int,
                     pad_mode: str = "replicate") -> np.ndarray:
    """(dst_d, 3, src_d) float64 table M: output row d, depth tap t reads the
    coarse rows ``R[d + t - 1]`` of the depth resize R, with the conv's depth
    padding baked in (replicate: an index clamp; zeros: a zero row). kind:
    'linear' (align_corners=True, the up2) or 'nearest' (the skip resizes)."""
    if kind == "linear":
        a = _linear_matrix(src_d, dst_d)
    elif kind == "nearest":
        a = _nearest_matrix(src_d, dst_d)
    else:
        raise ValueError(f"depth expansion kind {kind!r}")
    idx = np.arange(dst_d)[:, None] + np.arange(3)[None, :] - 1
    m = a[np.clip(idx, 0, dst_d - 1)]
    if pad_mode != "replicate":
        m = m * ((idx >= 0) & (idx < dst_d))[..., None]
    return m


@functools.lru_cache(maxsize=None)
def _expansion(blocks, dst_d, pad_mode, dtype, device):
    """The tables of ``blocks`` ((kind, src_d) each) side by side as the
    (dst_d, 3 * sum src_d) matrix of the expansion product, columns in
    (block, k, t) order, in ``dtype`` on ``device``."""
    m = [tap_expand_table(kind, src, dst_d, pad_mode).transpose(0, 2, 1).reshape(dst_d, -1)
         for kind, src in blocks]
    return torch.from_numpy(np.concatenate(m, axis=1)).to(device=device, dtype=dtype)


def coarse_input(x, padding, pad_mode):
    """The 2-D conv's input: x (B, C, S, H, W) as B·S channels-last images,
    replicate-padded in H and W where the conv asks for it (PyTorch's CUDA
    padding returns a contiguous NCHW tensor: made channels-last after)."""
    b, c, s, h, w = x.shape
    x2 = x.transpose(1, 2).reshape(b * s, c, h, w)
    _, ph, pw = padding
    if pad_mode == "replicate" and (ph or pw):
        x2 = F.pad(x2, (pw, pw, ph, ph), mode="replicate")
    return x2.contiguous(memory_format=torch.channels_last)


def fused_resize_conv(x, weight, dst_d, kind, pad_mode, padding, bias=None):
    """conv3d(depth_resize(x, dst_d), weight) + bias without the fine-depth
    volume.

    x: (B, C, S, H, W), depth-COARSE, H and W already at the conv's size;
    weight: (CO, C, 3, kh, kw) in x's dtype; ``padding`` the conv's (1, ph,
    pw). Returns (B, CO, dst_d, H, W), channels-last memory."""
    return expand_conv([coarse_input(x, padding, pad_mode)], [weight], [kind],
                       x.shape[0], dst_d, pad_mode, padding, bias)


def expand_conv(images, weights, kinds, batch, dst_d, pad_mode, padding, bias=None):
    """The sum over blocks of ``fused_resize_conv``, from each block's
    ``coarse_input`` images: per block one tap-major 2-D conv, then one
    ``depth_expand`` of them all. A block at the output depth (kind
    'linear' with src_d = dst_d, an identity resize) is an ordinary 3^3
    conv: its expansion is the shift-add of its three taps."""
    _, ph, pw = padding
    conv_pad = 0 if pad_mode == "replicate" else (ph, pw)
    convs = []
    for x2, w in zip(images, weights):
        kcat = w.permute(2, 0, 1, 3, 4).reshape(3 * w.shape[0], w.shape[1], *w.shape[3:])
        convs.append(F.conv2d(x2, kcat, None, 1, conv_pad))  # (B·S, 3·CO, H, W)
    return depth_expand(convs, kinds, batch, dst_d, pad_mode, bias)


def depth_expand(convs, kinds, batch, dst_d, pad_mode, bias=None):
    """y[d] = sum over blocks, taps t and rows k of M[d,t,k] u_t[k] (+ bias)
    for tap-major coarse conv outputs u (B·S, 3·CO, H, W): the taps regrouped
    on the coarse side into one (B, sum S, 3, H, W, CO) buffer (one copy),
    then one batched product that writes y (B, CO, dst_d, H, W) once,
    channels-last."""
    co = convs[0].shape[1] // 3
    h, w = convs[0].shape[2:]
    rows = [u.shape[0] // batch for u in convs]
    u = torch.cat([u.permute(0, 2, 3, 1).reshape(batch, s, h * w, 3, co).transpose(2, 3)
                   for u, s in zip(convs, rows)], dim=1).view(batch, 3 * sum(rows), -1)
    m = _expansion(tuple(zip(kinds, rows)), dst_d, pad_mode, u.dtype, u.device)
    m = m.expand(batch, -1, -1)
    if bias is None:
        y = torch.bmm(m, u)
    else:
        y = torch.baddbmm(bias.repeat(h * w).view(1, 1, -1), m, u)
    return y.view(batch, dst_d, h, w, co).permute(0, 4, 1, 2, 3)
