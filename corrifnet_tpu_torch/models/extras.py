"""Orphan component libraries (reference: utils.py + model_utils.py, present
in the reference repo but imported by nothing in it; SURVEY §2.2).

Counterpart of ``corrifnet_tpu/models/extras.py``, NCHW (image blocks) and
(B, N, C) tokens (attention blocks), a block library for architecture
experiments that no model and no entry point of either package reaches:

  * PIDNet blocks (model_utils.py:12-378): ``BasicBlock2d``,
    ``Bottleneck2d``, ``SegmentHead``, ``DAPPM``, ``PAPPM``, ``PagFM``,
    ``Bag``: the proportion-attention fusion and the deep- and
    parallel-aggregation pyramid poolings;
  * CrossViT blocks (utils.py:415-542): ``CrossAttention`` (the CLS token
    queries all tokens), ``Block`` (timm's pre-norm ViT block, which the
    reference imports), ``CrossAttentionBlock`` and ``MultiScaleBlock``.

The Swin blocks that utils.py also carries live in ``models/multisenseseg.py``
(``WindowAttention``, ``BasicBlock``, ``PatchMerging``), where MultiSenseSeg
runs them, and are re-exported here (``BasicBlock`` as ``SwinBlock``), as
the JAX module re-exports its own.

Each block takes its input widths as arguments (the JAX modules read them
from the input) and names its submodules as the JAX module names them, so
``models.jax_import.extras_state_dict_from_variables`` converts any block's
JAX variables. BatchNorm follows ``module.training`` (batch statistics and
the running update in training); the attention blocks have no dropout.
Convs and Linear layers take PyTorch's default init, as the JAX blocks do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.models.multisenseseg import BasicBlock as SwinBlock
from corrifnet_tpu_torch.models.multisenseseg import PatchMerging, WindowAttention
from corrifnet_tpu_torch.nn import BatchNorm, Conv, Dense, LayerNorm, avg_pool, resize_linear

__all__ = [
    "BasicBlock2d",
    "Bottleneck2d",
    "SegmentHead",
    "DAPPM",
    "PAPPM",
    "PagFM",
    "Bag",
    "CrossAttention",
    "CrossAttentionBlock",
    "Block",
    "MultiScaleBlock",
    "SwinBlock",
    "PatchMerging",
    "WindowAttention",
]


def _conv(cin, cout, kernel, stride=1, padding=0, groups=1, bias=False):
    return Conv(cin, cout, kernel, stride, padding, bias=bias, dims=2,
                kernel_init="torch_default", groups=groups)


class _Initialized(nn.Module):
    def reset_parameters(self, generator: torch.Generator):
        """Every submodule's own initializer, in module order."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self


class BasicBlock2d(_Initialized):
    """PIDNet BasicBlock (model_utils.py:12-46): two 3x3 conv-BN, the
    projection ``down_conv``/``down_bn`` where the shape changes, ReLU
    after the add unless ``no_relu``."""

    def __init__(self, inplanes, planes, stride=1, no_relu=False):
        super().__init__()
        self.no_relu = no_relu
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        self.down_conv = self.down_bn = None
        if stride != 1 or inplanes != planes:
            self.down_conv = _conv(inplanes, planes, 1, stride)
            self.down_bn = BatchNorm(planes)

    def forward(self, x):
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        res = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        out = y + res
        return out if self.no_relu else torch.relu(out)


class Bottleneck2d(_Initialized):
    """PIDNet Bottleneck, expansion 2 (model_utils.py:48-87): 1x1, 3x3
    (the stride), 1x1 to ``2 * planes``, each with its BatchNorm; no ReLU
    after the add by default."""

    def __init__(self, inplanes, planes, stride=1, no_relu=True):
        super().__init__()
        out = planes * 2
        self.no_relu = no_relu
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = BatchNorm(out)
        self.down_conv = self.down_bn = None
        if stride != 1 or inplanes != out:
            self.down_conv = _conv(inplanes, out, 1, stride)
            self.down_bn = BatchNorm(out)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        out = y + res
        return out if self.no_relu else torch.relu(out)


class SegmentHead(_Initialized):
    """segmenthead (model_utils.py:89-112): BN-ReLU-3x3 conv, BN-ReLU-1x1
    conv (with bias), bilinearly scaled up by ``scale_factor`` (corners not
    aligned)."""

    def __init__(self, inplanes, interplanes, outplanes, scale_factor: Optional[int] = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.bn1 = BatchNorm(inplanes)
        self.conv1 = _conv(inplanes, interplanes, 3, 1, 1)
        self.bn2 = BatchNorm(interplanes)
        self.conv2 = _conv(interplanes, outplanes, 1, bias=True)

    def forward(self, x):
        y = self.conv1(torch.relu(self.bn1(x)))
        out = self.conv2(torch.relu(self.bn2(y)))
        if self.scale_factor is not None:
            h, w = y.shape[2] * self.scale_factor, y.shape[3] * self.scale_factor
            out = resize_linear(out, (h, w), align_corners=False)
        return out


def _unit(parent, name, cin, cout, k, groups=1):
    """BN -> ReLU -> conv (padding k // 2, bias-free), the pyramid poolings'
    unit: ``{name}_bn`` and ``{name}_conv`` of ``parent``."""
    setattr(parent, f"{name}_bn", BatchNorm(cin))
    setattr(parent, f"{name}_conv", _conv(cin, cout, k, 1, k // 2, groups))


def _run(parent, name, x):
    return getattr(parent, f"{name}_conv")(torch.relu(getattr(parent, f"{name}_bn")(x)))


def _pools(x):
    """The pyramid's pooled inputs: average pools 5/2, 9/4, 17/8 (zeros
    counted in the divisor) and the global mean."""
    return [avg_pool(x, (5, 5), (2, 2), (2, 2)), avg_pool(x, (9, 9), (4, 4), (4, 4)),
            avg_pool(x, (17, 17), (8, 8), (8, 8)), x.mean(dim=(2, 3), keepdim=True)]


class DAPPM(_Initialized):
    """Deep-aggregation pyramid pooling (model_utils.py:114-194): five
    branches (the input and four pools), each BN-ReLU-1x1; the pooled ones
    up-sampled (corners not aligned), added to the branch before and
    processed by a BN-ReLU-3x3 in turn; compressed and added to the
    shortcut."""

    def __init__(self, inplanes, branch_planes, outplanes):
        super().__init__()
        for i in range(5):
            _unit(self, f"scale{i}", inplanes, branch_planes, 1)
        for i in range(1, 5):
            _unit(self, f"process{i}", branch_planes, branch_planes, 3)
        _unit(self, "compression", branch_planes * 5, outplanes, 1)
        _unit(self, "shortcut", inplanes, outplanes, 1)

    def forward(self, x):
        h, w = x.shape[2:]
        outs = [_run(self, "scale0", x)]
        for i, p in enumerate(_pools(x), start=1):
            s = resize_linear(_run(self, f"scale{i}", p), (h, w), align_corners=False)
            outs.append(_run(self, f"process{i}", s + outs[i - 1]))
        return _run(self, "compression", torch.cat(outs, dim=1)) + _run(self, "shortcut", x)


class PAPPM(_Initialized):
    """Parallel-aggregation pyramid pooling (model_utils.py:196-266): the
    pools of DAPPM, each up-sampled and added to the stride-1 branch, then
    processed together by one grouped 3x3 (4 groups); compressed with the
    stride-1 branch and added to the shortcut."""

    def __init__(self, inplanes, branch_planes, outplanes):
        super().__init__()
        for i in range(5):
            _unit(self, f"scale{i}", inplanes, branch_planes, 1)
        _unit(self, "scale_process", branch_planes * 4, branch_planes * 4, 3, groups=4)
        _unit(self, "compression", branch_planes * 5, outplanes, 1)
        _unit(self, "shortcut", inplanes, outplanes, 1)

    def forward(self, x):
        h, w = x.shape[2:]
        x_ = _run(self, "scale0", x)
        scales = [resize_linear(_run(self, f"scale{i}", p), (h, w), align_corners=False) + x_
                  for i, p in enumerate(_pools(x), start=1)]
        out = _run(self, "scale_process", torch.cat(scales, dim=1))
        comp = _run(self, "compression", torch.cat([x_, out], dim=1))
        return comp + _run(self, "shortcut", x)


class PagFM(_Initialized):
    """Pixel-attention-guided fusion (model_utils.py:268-312): the sigmoid
    of the channel sum (or, ``with_channel``, of a 1x1 conv-BN) of x's and
    up-sampled y's 1x1 conv-BN projections blends x with up-sampled y."""

    def __init__(self, in_channels, mid_channels, after_relu=False, with_channel=False):
        super().__init__()
        self.after_relu, self.with_channel = after_relu, with_channel
        for name, cin, cout in (("f_y", in_channels, mid_channels),
                                ("f_x", in_channels, mid_channels)) + (
                (("up", mid_channels, in_channels),) if with_channel else ()):
            setattr(self, f"{name}_conv", _conv(cin, cout, 1))
            setattr(self, f"{name}_bn", BatchNorm(cout))

    def _conv_bn(self, name, t):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(t))

    def forward(self, x, y):
        hw = tuple(x.shape[2:])
        if self.after_relu:
            x, y = torch.relu(x), torch.relu(y)
        y_q = resize_linear(self._conv_bn("f_y", y), hw, align_corners=False)
        x_k = self._conv_bn("f_x", x)
        if self.with_channel:
            sim = torch.sigmoid(self._conv_bn("up", x_k * y_q))
        else:
            sim = torch.sigmoid((x_k * y_q).sum(dim=1, keepdim=True))
        return (1 - sim) * x + sim * resize_linear(y, hw, align_corners=False)


class Bag(_Initialized):
    """Boundary-attention-guided fusion (model_utils.py:363-378): the
    sigmoid of ``d`` blends ``p`` and ``i``, then BN-ReLU-3x3."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.bn = BatchNorm(in_channels)
        self.conv = _conv(in_channels, out_channels, 3, 1, 1)

    def forward(self, p, i, d):
        edge = torch.sigmoid(d)
        return self.conv(torch.relu(self.bn(edge * p + (1 - edge) * i)))


def _attend(q, k, v, scale):
    """softmax(q k^T * scale) v over (B, heads, N, hd) tensors, the softmax
    in f32 and cast back, as the JAX blocks compute it."""
    attn = torch.softmax((q @ k.transpose(-2, -1) * scale).float(), dim=-1).to(q.dtype)
    return attn @ v


class CrossAttention(_Initialized):
    """CrossViT CLS-token attention (utils.py:415-444): the first token
    queries every token; the output is the updated CLS token (B, 1, C)."""

    def __init__(self, dim, num_heads=8, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        self.wq = Dense(dim, dim, bias=qkv_bias)
        self.wk = Dense(dim, dim, bias=qkv_bias)
        self.wv = Dense(dim, dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h

        def heads(t):
            return t.reshape(b, -1, h, hd).transpose(1, 2)

        out = _attend(heads(self.wq(x[:, 0:1])), heads(self.wk(x)), heads(self.wv(x)),
                      hd ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(b, 1, c))


class Block(_Initialized):
    """timm's pre-norm ViT ``Block``, which the reference's MultiScaleBlock
    imports (utils.py:8): LN -> attention (fused qkv, scale head_dim^-0.5,
    output projection) -> residual, LN -> fc1 -> GELU -> fc2 -> residual."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim)
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias)
        self.proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Dense(dim, int(dim * mlp_ratio))
        self.fc2 = Dense(int(dim * mlp_ratio), dim)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        out = _attend(qkv[0], qkv[1], qkv[2], (c // h) ** -0.5)
        x = x + self.proj(out.transpose(1, 2).reshape(b, n, c))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class CrossAttentionBlock(_Initialized):
    """utils.py:446-468: pre-norm CLS cross-attention with the residual on
    the CLS token, then (``has_mlp``) a pre-norm MLP on it; the output is
    the CLS stream (B, 1, C)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False, has_mlp=True):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = CrossAttention(dim, num_heads, qkv_bias)
        self.has_mlp = has_mlp
        if has_mlp:
            self.norm2 = LayerNorm(dim)
            self.fc1 = Dense(dim, int(dim * mlp_ratio))
            self.fc2 = Dense(int(dim * mlp_ratio), dim)

    def forward(self, x):
        cls = x[:, 0:1] + self.attn(self.norm1(x))
        if self.has_mlp:
            cls = cls + self.fc2(F.gelu(self.fc1(self.norm2(cls))))
        return cls


class MultiScaleBlock(_Initialized):
    """CrossViT multi-scale token fusion (utils.py:470-542): each branch's
    CLS token, LN-GELU-projected to the next branch's width, cross-attends
    over that branch's patch tokens (``max(depths[-1], 1)`` fusion blocks,
    no MLP) and is reverted (LN-GELU-linear) onto its own patch tokens.
    Returns the branches' token tensors, each of its input's shape.

    The JAX module's reference quirks hold: the projections are always
    built (the reference disables its identity shortcut with ``and
    False``), fusion block i takes ``mlp_ratios[i]`` (moot: no MLP), and
    the per-branch ``Block``s (``block{d}_{i}`` for ``depths[d] > 0``) hold
    parameters whose outputs the reference's forward discards. The JAX
    module traces them for XLA to drop; the port builds them, for the
    ``state_dict``, and does not run them, as it does not compute MMVit4's
    ``fusion5``."""

    def __init__(self, dims: Sequence[int], depths: Sequence[int],
                 num_heads: Sequence[int], mlp_ratios: Sequence[float], qkv_bias=False):
        super().__init__()
        nb = self.n_branches = len(dims)
        self.fusion_depth = max(depths[-1], 1)
        for d in range(nb):
            setattr(self, f"proj{d}_norm", LayerNorm(dims[d]))
            setattr(self, f"proj{d}_fc", Dense(dims[d], dims[(d + 1) % nb]))
        for i in range(nb):
            i1 = (i + 1) % nb
            for j in range(self.fusion_depth):
                setattr(self, f"fusion{i}_{j}", CrossAttentionBlock(
                    dims[i1], num_heads[i1], mlp_ratios[i], qkv_bias, has_mlp=False))
            setattr(self, f"revert{i}_norm", LayerNorm(dims[i1]))
            setattr(self, f"revert{i}_fc", Dense(dims[i1], dims[i]))
        for d in range(nb):
            for i in range(depths[d]):
                setattr(self, f"block{d}_{i}", Block(dims[d], num_heads[d], mlp_ratios[d],
                                                     qkv_bias))

    def forward(self, xs):
        nb = self.n_branches

        def lin(name, t):
            return getattr(self, f"{name}_fc")(F.gelu(getattr(self, f"{name}_norm")(t)))

        proj_cls = [lin(f"proj{d}", xs[d][:, 0:1]) for d in range(nb)]
        outs = []
        for i in range(nb):
            tmp = torch.cat([proj_cls[i], xs[(i + 1) % nb][:, 1:]], dim=1)
            for j in range(self.fusion_depth):
                tmp = getattr(self, f"fusion{i}_{j}")(tmp)
            outs.append(torch.cat([lin(f"revert{i}", tmp[:, 0:1]), xs[i][:, 1:]], dim=1))
        return outs
