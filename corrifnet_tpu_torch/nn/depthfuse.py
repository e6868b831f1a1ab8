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
own copies of its ``_linear_matrix`` and ``_nearest_matrix``, in
``nn/resize.py``) and cast to the compute dtype where they are
used, as the JAX module casts them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from corrifnet_tpu_torch.nn.pad import replicate_pad
from corrifnet_tpu_torch.nn.resize import _linear_matrix, _nearest_matrix

__all__ = ["coarse_input", "depth_expand", "expand_conv", "expand_rows",
           "fused_resize_conv", "table_columns", "tap_expand_table", "tap_major"]


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


def table_columns(table):
    """A (P, 3, S) tap table as the expansion product's (P, 3·S) columns,
    in (k, t) order."""
    return table.transpose(0, 2, 1).reshape(table.shape[0], -1)


def tap_major(w):
    """A (CO, CI, 3, kh, kw) 3-D conv weight as the 2-D conv weight (3·CO,
    CI, kh, kw) with the depth taps on the output channels."""
    return w.permute(2, 0, 1, 3, 4).reshape(3 * w.shape[0], w.shape[1], *w.shape[3:])


@functools.lru_cache(maxsize=None)
def _expansion(blocks, dst_d, pad_mode, dtype, device):
    """The tables of ``blocks`` ((kind, src_d) each) side by side as the
    (dst_d, 3 * sum src_d) matrix of the expansion product, columns in
    (block, k, t) order, in ``dtype`` on ``device``."""
    m = [table_columns(tap_expand_table(kind, src, dst_d, pad_mode)) for kind, src in blocks]
    return torch.from_numpy(np.concatenate(m, axis=1)).to(device=device, dtype=dtype)


def coarse_input(x, padding, pad_mode):
    """The 2-D conv's input: x (B, C, S, H, W) as B·S channels-last images,
    replicate-padded in H and W where the conv asks for it (``replicate_pad``
    returns a contiguous NCHW tensor: made channels-last after)."""
    b, c, s, h, w = x.shape
    x2 = x.transpose(1, 2).reshape(b * s, c, h, w)
    _, ph, pw = padding
    if pad_mode == "replicate" and (ph or pw):
        x2 = replicate_pad(x2, [(ph, ph), (pw, pw)])
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
        convs.append(F.conv2d(x2, tap_major(w), None, 1, conv_pad))  # (B·S, 3·CO, H, W)
    return depth_expand(convs, kinds, batch, dst_d, pad_mode, bias)


def depth_expand(convs, kinds, batch, dst_d, pad_mode, bias=None):
    """y[d] = sum over blocks, taps t and rows k of M[d,t,k] u_t[k] (+ bias)
    for tap-major coarse conv outputs u (B·S, 3·CO, H, W): the taps regrouped
    on the coarse side into one (B, sum S, 3, H, W, CO) buffer (one copy),
    then one batched product that writes y (B, CO, dst_d, H, W) once,
    channels-last."""
    rows = [u.shape[0] // batch for u in convs]
    m = _expansion(tuple(zip(kinds, rows)), dst_d, pad_mode, convs[0].dtype,
                   convs[0].device)
    return expand_rows(convs, m, batch, bias)


def expand_rows(convs, m, batch, bias=None):
    """``depth_expand`` with the expansion given as a matrix: m (P, 3 * sum
    S) in (block, k, t) column order, as ``_expansion`` lays it out; y (B,
    CO, P, H, W), channels-last. (The chunked lean stages pass a band of
    the tables' rows.)"""
    co = convs[0].shape[1] // 3
    h, w = convs[0].shape[2:]
    rows = [u.shape[0] // batch for u in convs]
    dst_d = m.shape[0]
    u = torch.cat([u.permute(0, 2, 3, 1).reshape(batch, s, h * w, 3, co).transpose(2, 3)
                   for u, s in zip(convs, rows)], dim=1).view(batch, 3 * sum(rows), -1)
    m = m.expand(batch, -1, -1)
    if bias is None:
        y = torch.bmm(m, u)
    else:
        y = torch.baddbmm(bias.repeat(h * w).view(1, 1, -1), m, u)
    return y.view(batch, dst_d, h, w, co).permute(0, 4, 1, 2, 3)
