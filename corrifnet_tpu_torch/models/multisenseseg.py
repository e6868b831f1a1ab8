"""MultiSenseSeg: per-modality MSE heads, AMM cross-modality fusion, a
Swin-style windowed backbone, a PPM/FPN neck and a gated decode head
(reference MultiSenseSeg.py:1137-1297, built as ``MultiSenseSeg(n_classes=1,
in_chans=(3,3,3), n_branch=3)``), for inference and training.

Counterpart of ``corrifnet_tpu/models/multisenseseg.py``, NCHW and (B, L, C)
tokens inside, with the reference ``state_dict`` layout that
``corrifnet_tpu.models.torch_import.multisenseseg_variables_from_state_dict``
reads (``build_MSEs_AMM``, ``build_pipeline``, ``build_neck``,
``build_decode_head``; ``nn.Identity`` placeholders keep the reference's
Sequential indices where a pooling or an activation stands before a conv).

The quirks the JAX module keeps are kept:
  * the angular positional scalars are the constants cos 0°, cos 45° and
    cos 90° (the reference holds them in a plain list, never registered);
  * the token BatchNorm of each Swin block emits (B, C, L), and ``CNNMlp``
    reads that buffer row-major as (B, L, C) reshaped to (B, C, H, W): the
    scramble of the reference (MultiSenseSeg.py:352);
  * AMM: channel-by-channel cosine similarity with the clamped
    log-scaled temperature, the sigmoid of the channel-pair bias MLP over a
    static log-scaled offset table, the inverted double softmax
    ``softmax(1 - softmax(sim))`` in f32, heads that split the flattened
    *spatial* axis, and q and k through MaxPool(8) and an *unpadded*
    depthwise 3x3 conv (28 -> 26 at a 224 input);
  * the output, a sigmoid in f32, repeated over the 3 modalities:
    (B, 3, 1, H, W).

The windowed attention is plain PyTorch (products and an f32 softmax, cast
back to the compute dtype), as it is XLA in JAX: q and k are 1.5 times
narrower than v (``QK_RATIO``), the relative position bias is gathered from
its table, shifted windows roll the token grid and mask with -100, and H
and W are zero-padded up to the window (at 224: 56, 28 -> 32, 14 -> 16,
7 -> 8).

Dropout runs at the JAX module's fixed rates in training mode: ``pos_drop``,
each block's ``attn_drop`` and ``proj_drop``, CNNMlp's ``d1``-``d3`` and
AMM's two sites at 0.1, and a per-sample DropPath at ``linspace(0, 0.1,
14)`` over the blocks, whose one module per block draws a mask at each of
its two calls. Every mask comes from the ``DropoutRng`` given to
``set_dropout_rng``, in the JAX module's call order.

The JAX module's two options, which neither entry point of either package
reaches (the JAX package builds MultiSenseSeg with ``dtype`` alone and runs
none of its Pallas kernels on it):

  * ``use_faster``: the residual CNN backbone (``CNNBackbone``, blocks 3, 4,
    6, 3 at widths 64, 128, 256, 512) in place of the Swin one, with
    ``embed_dim`` forced to 64 in AMM, PPM and the FPN neck
    (MultiSenseSeg.py:1185, 1231);
  * ``aux``: the auxiliary FCN head over the penultimate level (``aux_conv``,
    3x3 conv-BN-ReLU to 256, and ``aux_head``, 1x1 to the classes). Its map
    does not change ``forward``'s return: the JAX module sows it as the
    intermediate ``aux_out``, and the port's ``capture_aux()`` hands it out
    through a forward hook on ``aux_head``. Its parameters take no gradient
    from the model's loss, as in the JAX module.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.nn import (
    BatchNorm,
    Conv,
    Dense,
    LayerNorm,
    adaptive_max_pool,
    max_pool,
    resize_linear,
)

__all__ = ["CNNBackbone", "CNNBlock", "MultiSenseSeg"]

DROP = 0.1  # every dropout site's rate, and DropPath's largest
# the configuration the JAX package builds (its module's defaults)
N_BRANCH = 3  # modalities
HEAD_OUT = 32  # each MSE's channels
EMBED_DIM = 96  # the Swin backbone's first stage
FASTER_DIM = 64  # embed_dim under use_faster (the CNN backbone's first stage)
NUM_HEADS = (3, 6, 12, 24)
WINDOW = 8
GROUP_DIM = 8  # channels per group of the even blocks' CNNMlp
QK_RATIO = 1.5  # v over q and k widths
MLP_RATIO = 4
CHAN_RATIO = 8  # the SE squeeze
DECODER = 512  # the neck's channels


def _activate(y, act):
    if act == "relu":
        return torch.relu(y)
    if act == "relu6":
        return torch.relu(y).clamp_max(6.0)
    if act == "gelu":
        return F.gelu(y)  # exact, as jax.nn.gelu(approximate=False)
    return y


def _conv(cin, cout, kernel=1, stride=1, padding=0, groups=1, bias=True):
    return Conv(cin, cout, kernel, stride, padding, bias=bias, dims=2,
                kernel_init="torch_default", groups=groups)


def _dropout(x, rate, rng):
    """Inverted dropout of ``x`` with a keep mask of its shape from ``rng``."""
    return torch.where(rng.keep(x, rate), x / (1.0 - rate), torch.zeros_like(x))


class _Stochastic(nn.Module):
    """A module whose training-mode dropout draws from the model's
    ``DropoutRng`` (set by ``MultiSenseSeg.set_dropout_rng``)."""

    rng = None

    def drop(self, x, rate):
        if not self.training or rate == 0.0:
            return x
        if self.rng is None:
            raise RuntimeError(
                "training MultiSenseSeg needs set_dropout_rng(DropoutRng(seed, device))")
        return _dropout(x, rate, self.rng)


class _ConvBNAct(nn.Sequential):
    """conv -> BatchNorm -> activation on NCHW input, held as the
    reference's Sequential: ``lead`` placeholders (a pooling or activation
    that comes first there), the conv, then the BatchNorm if ``bn``."""

    def __init__(self, cin, cout, kernel=3, stride=1, padding=0, groups=1, bias=True,
                 bn=True, act="relu", lead=0):
        mods = [nn.Identity() for _ in range(lead)]
        mods.append(_conv(cin, cout, kernel, stride, padding, groups, bias))
        if bn:
            mods.append(BatchNorm(cout))
        super().__init__(*mods)
        self.lead, self.bn, self.act = lead, bn, act

    def forward(self, x):
        y = self[self.lead](x)
        if self.bn:
            y = self[self.lead + 1](y)
        return _activate(y, self.act)


class SEAttention(nn.Module):
    """Squeeze and excitation (MultiSenseSeg.py:79-91): the reference's
    Sequential(avg pool, conv, ReLU6, conv, sigmoid) as ``attn``."""

    def __init__(self, chans, ratio):
        super().__init__()
        self.attn = nn.Sequential(nn.Identity(), _conv(chans, chans // ratio, bias=False),
                                  nn.Identity(), _conv(chans // ratio, chans, bias=False))

    def forward(self, x):
        w = x.mean(dim=(2, 3), keepdim=True)
        w = self.attn[3](_activate(self.attn[1](w), "relu6"))
        return x * torch.sigmoid(w.float()).to(x.dtype)


class CBAMAttention(nn.Module):
    """CBAM's channel attention over the average and the max (the JAX
    module's ``chan_attn_type='CBAM'``; MultiSenseSeg builds its MSEs with
    SE)."""

    def __init__(self, chans, ratio):
        super().__init__()
        self.conv1 = _conv(chans, chans // ratio, bias=False)
        self.conv2 = _conv(chans // ratio, chans, bias=False)

    def forward(self, x):
        def mlp(t):
            return self.conv2(_activate(self.conv1(t), "relu6"))

        avg = mlp(x.mean(dim=(2, 3), keepdim=True))
        mx = mlp(x.amax(dim=(2, 3), keepdim=True))
        return x * torch.sigmoid((avg + mx).float()).to(x.dtype)


class MSE(nn.Module):
    """Modality-specific extractor (MultiSenseSeg.py:920-954)."""

    def __init__(self, pos):
        super().__init__()
        c, half = HEAD_OUT, HEAD_OUT // 2
        self.pos = pos
        self.conv1 = _ConvBNAct(3, c, 3, 1, 1, bias=False)
        self.conv2 = _conv(c, half, bias=False)
        # conv3_dw (3x3 in half // GROUP_DIM groups, BatchNorm), conv3_pw (1x1, ReLU)
        self.conv3 = nn.Sequential(_conv(half, half, 3, 1, 1, groups=half // GROUP_DIM),
                                   BatchNorm(half), _conv(half, c))
        self.attn = SEAttention(c, CHAN_RATIO)

    def forward(self, x):
        x = self.conv1(x)
        y = self.conv2(x) + torch.tensor(self.pos, dtype=x.dtype)
        y = self.conv3[1](self.conv3[0](y))
        y = torch.relu(self.conv3[2](y)) + x
        return self.attn(y)


@functools.lru_cache(maxsize=None)
def _amm_relative_bias(c: int) -> np.ndarray:
    """Log-scaled signed channel-offset table (MultiSenseSeg.py:987-993),
    (C, C, 1) float32."""
    coords = np.zeros((c, c), dtype=np.float64)
    for idx in range(c):
        coords[idx] = np.arange(c) - idx
    bias = coords / coords.max()
    bias *= 8
    bias = np.sign(bias) * np.log2(np.abs(bias) + 1.0) / np.log2(8)
    return bias[..., None].astype(np.float32)


class AMM(_Stochastic):
    """Cross-modality channel-attention fusion (MultiSenseSeg.py:957-1030)
    of the three MSEs' 96 channels: patches of 4 (``patch_size``), q and k
    pooled by 8 (``offset_scale``), 4 heads. Returns (fused (B, out_chans,
    H/4, W/4), the input); ``out_chans`` is the backbone's width, 96 (the
    Swin backbone's ``embed_dim``) or 64 (``use_faster``)."""

    offset_scale, patch_size, n_heads = 8, 4, 4

    def __init__(self, out_chans=HEAD_OUT * N_BRANCH):
        super().__init__()
        c = HEAD_OUT * N_BRANCH
        p, n_branch, n_heads = self.patch_size, N_BRANCH, self.n_heads
        self.short_cut_conv = nn.Sequential(_conv(c, out_chans, p, p),
                                            nn.Sequential(nn.Identity(), LayerNorm(out_chans)))
        self.q = _conv(c, c, groups=n_branch)
        self.k = _conv(c, c, groups=n_branch)
        self.v = _conv(c, c, groups=n_branch)
        # MaxPool(offset_scale), then the UNPADDED depthwise 3x3 (quirk)
        self.q_proj = nn.Sequential(nn.Identity(), _conv(c, c, 3, groups=c))
        self.k_proj = nn.Sequential(nn.Identity(), _conv(c, c, 3, groups=c))
        self.v_proj = _conv(c, c, p, p, groups=c)
        self.logit_scale = nn.Parameter(torch.empty(n_heads, 1, 1))
        self.cpb_mlp = nn.Sequential(Dense(1, 16 * n_branch), nn.Identity(),
                                     Dense(16 * n_branch, n_heads, bias=False))
        self.proj = nn.Sequential(_conv(c, c), nn.Identity(), _conv(c, out_chans))
        self.norm = nn.Sequential(nn.Identity(), LayerNorm(out_chans))
        # static (the JAX module builds it from numpy); not in the state_dict
        self.register_buffer("relative_position_bias",
                             torch.from_numpy(_amm_relative_bias(c)), persistent=False)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.logit_scale.fill_(math.log(10.0))

    def forward(self, x):
        b, c, H, W = x.shape
        p, nh, s = self.patch_size, self.n_heads, self.offset_scale
        sc = self.short_cut_conv[1][1](self.short_cut_conv[0](x).permute(0, 2, 3, 1))
        sc = sc.permute(0, 3, 1, 2)

        q = self.q_proj[1](max_pool(self.q(x), (s, s))).reshape(b, c, -1)
        k = self.k_proj[1](max_pool(self.k(x), (s, s))).reshape(b, c, -1)
        v = self.v_proj(self.v(x)).reshape(b, c, -1)

        def heads(t):  # the flattened spatial axis split (MultiSenseSeg.py:1008-1010)
            return t.reshape(b, c, nh, -1).transpose(1, 2)

        qh, kh, vh = heads(q), heads(k), heads(v)
        qn = qh / (torch.linalg.vector_norm(qh, dim=-1, keepdim=True) + 1e-12)
        kn = kh / (torch.linalg.vector_norm(kh, dim=-1, keepdim=True) + 1e-12)
        sim = (qn @ kn.transpose(-2, -1)).float()
        sim = sim * torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        h1 = torch.relu(self.cpb_mlp[0](self.relative_position_bias.to(x.dtype)))
        bias = torch.sigmoid(self.cpb_mlp[2](h1).permute(2, 0, 1))  # (nh, C, C)
        sim = sim + bias[None].float()
        sim = torch.softmax(1.0 - torch.softmax(sim, dim=-1), dim=-1).to(x.dtype)
        sim = self.drop(sim, DROP)

        out = (sim @ vh).transpose(1, 2).reshape(b, c, -1)
        out = out.reshape(b, -1, H // p, W // p)
        out = self.proj[2](F.gelu(self.proj[0](out)))
        out = self.drop(out, DROP)
        out = self.norm[1](out.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return out + sc, x


@functools.lru_cache(maxsize=None)
def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) index of each token pair's relative offset into the
    bias table (MultiSenseSeg.py's Swin window attention)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _swin_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """Shifted-window attention mask (MultiSenseSeg.py:686-705):
    (windows, window^2, window^2), -100 between tokens of different regions."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mask_tensor(hp, wp, window, shift, device):
    return torch.from_numpy(_swin_attn_mask(hp, wp, window, shift)).to(device)


class WindowAttention(_Stochastic):
    """Window self-attention (MultiSenseSeg.py:365-494): q and k of
    ``d // QK_RATIO // heads`` per head, v of ``d // heads``, the scale of
    the latter; the relative position bias from its table."""

    def __init__(self, dim, window, n_heads):
        super().__init__()
        self.dim, self.n_heads = dim, n_heads
        self.qkv_dim = int(dim + 2 * (dim // QK_RATIO // n_heads) * n_heads)
        self.qkv = Dense(dim, self.qkv_dim)
        self.proj = Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, n_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window, window).reshape(-1)),
            persistent=False)

    def reset_parameters(self, generator):
        t = self.relative_position_bias_table
        with torch.no_grad():
            t.copy_(torch.empty(t.shape).normal_(0.0, 0.02, generator=generator))

    def forward(self, x, mask=None):
        bw, n, d = x.shape
        nh = self.n_heads
        qkv = self.qkv(x)
        q, k = qkv[..., :self.qkv_dim - d].chunk(2, dim=-1)
        v = qkv[..., -d:]

        def heads(t):
            return t.reshape(bw, n, nh, -1).transpose(1, 2)

        attn = (heads(q) @ heads(k).transpose(-2, -1)) * (d // nh) ** -0.5
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, nh).permute(2, 0, 1)[None].to(attn.dtype)
        attn = attn.float()
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(bw // nw, nw, nh, n, n) + mask[None, :, None]).view(bw, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        attn = self.drop(attn, DROP)
        out = (attn @ heads(v)).transpose(1, 2).reshape(bw, n, d)
        return self.drop(self.proj(out), DROP)


class CNNMlp(_Stochastic):
    """Grouped-conv token FFN with the (B, C, L) -> (B, L, C) ->
    view(B, C, H, W) scramble (MultiSenseSeg.py:330-362, 894-917)."""

    def __init__(self, in_chans, hidden, n_group):
        super().__init__()
        self.convup = nn.Sequential(_conv(in_chans, hidden, groups=n_group))
        self.dw_conv = _ConvBNAct(hidden, hidden, 3, 1, 1, groups=hidden, bias=False,
                                  act="gelu")
        self.convdown = _conv(hidden, in_chans)

    def forward(self, x_bcl, H, W):
        b, c, _ = x_bcl.shape
        # (B, C, L).transpose(1, 2).view(B, C, H, W): the row-major
        # reinterpretation of the (L, C) buffer (the scramble, kept)
        x = x_bcl.transpose(1, 2).reshape(b, c, H, W)
        y = self.drop(F.gelu(self.convup[0](x)), DROP)
        y = self.drop(self.dw_conv(y), DROP)
        y = self.drop(self.convdown(y), DROP)
        return (x + y).reshape(b, c, -1).transpose(1, 2)  # (B, L, C)


class DropPath(_Stochastic):
    """Per-sample stochastic depth: a sample's whole residual branch kept
    with probability 1 - rate (and scaled by its inverse) or zeroed."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rng is None:
            raise RuntimeError(
                "training MultiSenseSeg needs set_dropout_rng(DropoutRng(seed, device))")
        keep = self.rng.keep(x[(slice(None),) + (slice(0, 1),) * (x.dim() - 1)], self.rate)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class BasicBlock(nn.Module):
    """Swin block with shift and the CNN FFN (MultiSenseSeg.py:553-630):
    LayerNorm, (shifted) window attention, DropPath residual; the token
    BatchNorm, CNNMlp, DropPath residual."""

    def __init__(self, dim, n_heads, shift, drop_path, grouped):
        super().__init__()
        self.window, self.shift = WINDOW, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, WINDOW, n_heads)
        self.drop_path = DropPath(drop_path)
        # the reference's Sequential(Rearrange, BatchNorm1d) over (B, C, L)
        self.norm2 = nn.Sequential(nn.Identity(), BatchNorm(dim))
        self.mlp = CNNMlp(dim, dim * MLP_RATIO, dim // GROUP_DIM if grouped else 1)

    def forward(self, x, H, W):
        b, l, c = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x).reshape(b, H, W, c)
        pad_r, pad_b = (w - W % w) % w, (w - H % w) % w
        if pad_r or pad_b:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = y.shape[1], y.shape[2]
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = _mask_tensor(hp, wp, w, s, y.device)
        y = y.view(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)
        y = self.attn(y, mask)
        y = y.view(b, hp // w, wp // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        y = y[:, :H, :W].reshape(b, l, c)
        x = x + self.drop_path(y)
        # token BatchNorm per channel over (B, L), emitted as (B, C, L)
        normed = self.norm2[1](x.transpose(1, 2))
        return self.drop_path(self.mlp(normed, H, W)) + x


class PatchMerging(nn.Module):
    """Downsampling_block (MultiSenseSeg.py:522-550): 2x2 neighbours
    concatenated (zero-padded where H or W is odd), LayerNorm, a bias-free
    Linear to ``out_chans``."""

    def __init__(self, chans, out_chans):
        super().__init__()
        self.ln = LayerNorm(4 * chans)
        self.reduction = Dense(4 * chans, out_chans, bias=False)

    def forward(self, x, H, W):
        b, _, c = x.shape
        y = x.reshape(b, H, W, c)
        if H % 2 or W % 2:
            y = F.pad(y, (0, 0, 0, W % 2, 0, H % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2],
                       y[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.ln(y.reshape(b, -1, 4 * c)))


class _SwinStage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.long_blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinBackbone(_Stochastic):
    """Build_backbone (MultiSenseSeg.py:722-842) without a patch embedding
    (the default configuration): ``pos_drop``, four stages of ``depths``
    blocks, unshifted (their CNNMlp grouped) and shifted in turn, at
    EMBED_DIM * 2^i channels with PatchMerging between, each stage's output
    LayerNorm'd (``norm{i}``) and returned NCHW."""

    def __init__(self, depths):
        super().__init__()
        self.depths = tuple(depths)
        dpr = np.linspace(0, DROP, sum(depths))
        stages, offset = [], 0
        for li, depth in enumerate(depths):
            d = EMBED_DIM * 2 ** li
            blocks = [BasicBlock(d, NUM_HEADS[li], 0 if i % 2 == 0 else WINDOW // 2,
                                 float(dpr[offset + i]), i % 2 == 0)
                      for i in range(depth)]
            offset += depth
            merge = PatchMerging(d, 2 * d) if li < len(depths) - 1 else None
            stages.append(_SwinStage(blocks, merge))
            setattr(self, f"norm{li}", LayerNorm(d))
        self.layers = nn.ModuleList(stages)

    def forward(self, x_nchw):
        b, c, H, W = x_nchw.shape
        x = self.drop(x_nchw.reshape(b, c, H * W).transpose(1, 2), DROP)
        outs = []
        for li, stage in enumerate(self.layers):
            for block in stage.long_blocks:
                x = block(x, H, W)
            out = getattr(self, f"norm{li}")(x)
            outs.append(out.reshape(b, H, W, -1).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
        return outs


class CNNBlock(nn.Module):
    """CNN_Block (MultiSenseSeg.py:845-867): 3x3 conv-BN-ReLU, 3x3 conv-BN,
    a 1x1 conv-BN projection shortcut where the shape changes, ReLU after
    the residual add. Convs bias-free."""

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.c1 = _ConvBNAct(cin, planes, 3, stride, 1, bias=False)
        self.c2 = _ConvBNAct(planes, planes, 3, 1, 1, bias=False, act="none")
        self.short = None
        if stride != 1 or cin != planes:
            self.short = _ConvBNAct(cin, planes, 1, stride, 0, bias=False, act="none")

    def forward(self, x):
        y = self.c2(self.c1(x))
        return torch.relu(y + (x if self.short is None else self.short(x)))


class CNNBackbone(nn.Module):
    """CNN_backbone (MultiSenseSeg.py:870-892), the ``use_faster`` backbone:
    four stages of (3, 4, 6, 3) ``CNNBlock``s at widths c, 2c, 4c, 8c and
    strides 1, 2, 2, 2 (stage 1 keeps AMM's resolution); each stage's
    output is a level. Blocks are named as the JAX module's,
    ``layer{stage}_block{i}``."""

    STAGES = ((3, 1, 1), (4, 2, 2), (6, 4, 2), (3, 8, 2))  # blocks, width x, stride

    def __init__(self, chans=64):
        super().__init__()
        self.names, cin = [], chans
        for li, (blocks, mult, stride) in enumerate(self.STAGES):
            stage = []
            for bi in range(blocks):
                name = f"layer{li + 1}_block{bi}"
                setattr(self, name, CNNBlock(cin, chans * mult, stride if bi == 0 else 1))
                stage.append(name)
                cin = chans * mult
            self.names.append(stage)

    def forward(self, x):
        outs = []
        for stage in self.names:
            for name in stage:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


class PPM(nn.Module):
    """Pyramid pooling over the deepest level: adaptive max pools to 1, 2,
    3 and 6, each a bias-free 1x1 conv and ReLU, resized back with aligned
    corners and concatenated with the input, then ``bottom``."""

    pool_sizes = (1, 2, 3, 6)

    def __init__(self, in_chans):
        super().__init__()
        self.pool_projs = nn.ModuleList(
            nn.Sequential(nn.Identity(), _conv(in_chans, DECODER, bias=False))
            for _ in self.pool_sizes)
        self.bottom = _ConvBNAct(in_chans + len(self.pool_sizes) * DECODER, DECODER, 3, 1, 1,
                                 bias=False)

    def forward(self, x):
        h, w = x.shape[2:]
        xs = [x]
        for ps, proj in zip(self.pool_sizes, self.pool_projs):
            y = torch.relu(proj[1](adaptive_max_pool(x, (ps, ps))))
            xs.append(resize_linear(y, (h, w), align_corners=True))
        return self.bottom(torch.cat(xs, dim=1))


class FPNNeck(nn.Module):
    """The FPN over the reversed levels (deepest first, the deepest already
    through PPM): each level's lateral 1x1 plus a 3x3 of the level above
    up-sampled x2, all resized to the finest and fused by ``out``. Level i
    (finest first) has ``embed_dim * 2^i`` channels."""

    def __init__(self, depth, embed_dim=EMBED_DIM):
        super().__init__()
        self.conv_ = nn.ModuleList(
            _ConvBNAct(embed_dim * 2 ** (depth - 2 - i), DECODER, 1, bias=False)
            for i in range(depth - 1))
        self.fpn_conv = nn.ModuleList(
            _ConvBNAct(DECODER, DECODER, 3, 1, 1, bias=False) for _ in range(depth - 1))
        self.out = _ConvBNAct(DECODER * depth, DECODER, 3, 1, 1, bias=False)

    def forward(self, feats):
        feats = list(feats)
        out = [feats[0]]
        for i in range(len(self.conv_)):
            up = resize_linear(feats[i], (feats[i].shape[2] * 2, feats[i].shape[3] * 2),
                               align_corners=True)
            feats[i + 1] = self.fpn_conv[i](up) + self.conv_[i](feats[i + 1])
            out.append(feats[i + 1])
        out = out[::-1]
        h, w = out[0].shape[2:]
        out = [out[0]] + [resize_linear(t, (h, w), align_corners=True) for t in out[1:]]
        return self.out(torch.cat(out, dim=1))


class _SpatialAttention(nn.Module):
    """Spatial_attention (MultiSenseSeg.py:41-65)'s layout: ``conv1`` =
    (MaxPool(4), 1x1 conv, BatchNorm), ``conv2`` = (1x1 conv, BatchNorm),
    ``attn`` = (ReLU, 1x1 conv to one channel, BatchNorm)."""

    def __init__(self, en_chans, head):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Identity(), _conv(en_chans, head), BatchNorm(head))
        self.conv2 = _ConvBNAct(head, head, 1, act="none")
        self.attn = _ConvBNAct(head, 1, 1, act="none", lead=1)


class DecodeGate(nn.Module):
    """Build_decode_gate (MultiSenseSeg.py:112-160): the neck's features
    through a 3x3 conv, gated by a spatial attention that also reads the
    encoder's smoothed features and by SE, a depthwise 3x3 and a 1x1 back,
    the residual and ReLU, the 1x1 classifier, and x4 up-sampling with
    aligned corners."""

    def __init__(self):
        super().__init__()
        head = DECODER // 2
        self.conv = _ConvBNAct(DECODER, head, 3, 1, 1, bias=False, act="none")
        self.spat_attn = _SpatialAttention(HEAD_OUT, head)
        self.chan_attn = SEAttention(head, CHAN_RATIO)
        # dw1 (depthwise 3x3 and BatchNorm), then dw2 (bias-free 1x1)
        self.dwconv = nn.Sequential(_conv(head, head, 3, 1, 1, groups=head), BatchNorm(head),
                                    _conv(head, DECODER, bias=False))
        self.out = nn.Sequential(nn.Identity(), _conv(DECODER, 1))

    def forward(self, x_en, x_de):
        y = self.conv(x_de)
        sa = self.spat_attn
        en = sa.conv1[2](sa.conv1[1](max_pool(x_en, (4, 4))))
        de = sa.conv2(y)
        a = sa.attn(torch.relu(en + de))
        # the gate multiplies the conv2-transformed decoder features
        spat = de * torch.sigmoid(a.float()).to(y.dtype)
        f = spat + self.chan_attn(y)
        f = self.dwconv[2](self.dwconv[1](self.dwconv[0](f)))
        out = self.out[1](torch.relu(x_de + f))
        return resize_linear(out, (out.shape[2] * 4, out.shape[3] * 4), align_corners=True)


class _MSEsAMM(nn.Module):
    """The reference's ``build_MSEs_AMM`` container: the three MSEs, AMM as
    ``fuse_proj`` and the ``smooth`` conv of the fused input."""

    def __init__(self, msed, amm, smooth):
        super().__init__()
        self.MSEs = nn.ModuleList(msed)
        self.fuse_proj = amm
        self.smooth = smooth


class _Neck(nn.Module):
    def __init__(self, ppm, fpn):
        super().__init__()
        self.ppm_head = ppm
        self.fpn_neck = fpn


class MultiSenseSeg(nn.Module):
    """Input (B, 3 modalities, 3 bands, H, W), H and W multiples of 32 with
    (H/8 - 2)^2 a multiple of 4 (AMM's heads); output sigmoid probabilities
    (B, 3, 1, H, W) in f32. ``depths`` is the Swin stages' block counts,
    the JAX module's field; ``use_faster`` and ``aux`` are its options (see
    the module docstring). ``transformer_dropout`` has no effect: the
    dropout rates are the JAX module's fixed ones."""

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1,
                 depths: Tuple[int, ...] = (2, 2, 8, 2), use_faster: bool = False,
                 aux: bool = False):
        super().__init__()
        del transformer_dropout  # MultiSenseSeg's dropout rates are fixed
        self.compute_dtype = dtype
        # use_faster forces embed_dim 64 (MultiSenseSeg.py:1185)
        ed = FASTER_DIM if use_faster else EMBED_DIM
        ang_table = list(range(0, 136, 135 // N_BRANCH))
        mses = [MSE(math.cos(ang_table[i] * math.pi / 180)) for i in range(N_BRANCH)]
        smooth = _ConvBNAct(HEAD_OUT * N_BRANCH, HEAD_OUT, 3, 1, 1, bias=False)
        self.build_MSEs_AMM = _MSEsAMM(mses, AMM(ed), smooth)
        if use_faster:
            self.build_pipeline = CNNBackbone(ed)
            depth = len(CNNBackbone.STAGES)
        else:
            self.build_pipeline = SwinBackbone(depths)
            depth = len(depths)
        self.build_neck = _Neck(PPM(ed * 2 ** (depth - 1)), FPNNeck(depth, ed))
        self.build_decode_head = DecodeGate()
        self.aux_conv = self.aux_head = None
        if aux:
            # the auxiliary FCN head over the penultimate level
            # (MultiSenseSeg.py:1251-1256): 3x3 conv-BN-ReLU to 256, 1x1 conv
            self.aux_conv = _ConvBNAct(ed * 2 ** (depth - 2), DECODER // 2, 3, 1, 1,
                                       bias=False)
            self.aux_head = _conv(DECODER // 2, 1)

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        PyTorch's default conv and Linear initializers, LayerNorm and
        BatchNorm ones and zeros, the bias tables N(0, 0.02) and AMM's
        ``logit_scale`` log 10 (the JAX module's)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    @contextlib.contextmanager
    def capture_aux(self):
        """Inside the block, each forward of a model built with ``aux`` puts
        its auxiliary map, (B, 1, H/16, W/16) in the compute dtype (with its
        graph in training), under ``"aux_out"`` of the dict this yields:
        what ``mutable=["intermediates"]`` reads from the JAX module's
        ``sow``. ``forward``'s return is the same with ``aux`` on or off."""
        if self.aux_head is None:
            raise ValueError("capture_aux needs a MultiSenseSeg built with aux=True")
        out = {}
        hook = self.aux_head.register_forward_hook(
            lambda module, args, result: out.__setitem__("aux_out", result))
        try:
            yield out
        finally:
            hook.remove()

    def set_dropout_rng(self, rng):
        """Give every dropout site and DropPath the randomness of its masks."""
        for module in self.modules():
            if isinstance(module, _Stochastic):
                module.rng = rng
        return self

    def forward(self, x):
        x = x.to(self.compute_dtype)
        head = self.build_MSEs_AMM
        cat = torch.cat([mse(x[:, i]) for i, mse in enumerate(head.MSEs)], dim=1)
        amm_out, short_cut = head.fuse_proj(cat)
        de_x = head.smooth(short_cut)
        feats = self.build_pipeline(amm_out)
        if self.aux_head is not None:
            # the aux map: aux_head's output, read with a forward hook
            # (``capture_aux``), as JAX sows it (``intermediates/aux_out``)
            self.aux_head(self.aux_conv(feats[-2]))
        rev = feats[::-1]
        rev[0] = self.build_neck.ppm_head(rev[0])
        neck = self.build_neck.fpn_neck(rev)
        out = self.build_decode_head(de_x, neck)
        out = torch.sigmoid(out.float())  # (B, classes, H, W)
        return out[:, None].repeat(1, N_BRANCH, 1, 1, 1)
