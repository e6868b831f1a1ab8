"""FASSDNet (reference F28_FASSDNet.py:272-377), for inference and
training, on the 4-D input path.

Counterpart of ``corrifnet_tpu/models/fassdnet.py``, NCHW, with the
reference ``state_dict`` layout that
``corrifnet_tpu.models.torch_import.fassdnet_variables_from_state_dict``
reads: ``base`` (a ModuleList of the four stem ConvLayers, then each
HarDBlock, its transition ConvLayer and, but after the last, its AvgPool,
held as an ``nn.Identity`` placeholder so that the indices are the
reference's), ``DAPF``, ``conv1x1_up.{i}``, ``mda.{i}``,
``denseBlocksUp.{i}`` and ``finalConv``:

  * the HarDNet encoder: a stem of four 3x3 ConvLayers (conv, BatchNorm,
    ReLU; strides 2, 1, 2, 1), four HarDBlocks of the harmonic link topology
    (F28:182-242; ``hard_block_link``) each followed by a 1x1 transition
    ConvLayer, with 2x2 average pooling between them;
  * DAPF (F28:48-92) on the stride-32 map: a 1x1 branch and three dilated
    asymmetric (3x1 then 1x3) branches at rates 12, 24 and 36,
    concatenated, a 1x1 conv, BatchNorm and ReLU;
  * three decoder levels: TransitionUp (a bilinear ``align_corners=True``
    resize to the skip's size, then the two concatenated), a 1x1 ConvLayer
    to half the channels, MDA (F28:132-163: BNPReLU, a 3x3 conv and
    BNPReLU, a 3x3 branch beside a (3,1)/(1,3) branch dilated per axis,
    summed, BNPReLU, a 1x1 conv, the input added; BatchNorm eps 1e-3, one
    PReLU slope per channel, named ``acti``) and a HarDBlock;
  * a 1x1 conv with bias, a bilinear ``align_corners=True`` resize to the
    input and the sigmoid in f32.

MDA's dilations follow the code, which pops the dilation list at the
block indices 2, 1, 0 going up: 8, 4, 2 (F28:324-329; the JAX module's
docstring says 16/8/4, ROADMAP.md "Not faults"). DAPF's and its branches'
convs are kaiming-normal initialized (F28:40-46, 86-92), every other conv
keeps PyTorch's default. FASSDNet has no dropout. The JAX package builds it
with ``dtype`` alone and runs none of its Pallas kernels on it.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn import BatchNorm, Conv, PReLU, avg_pool, resize_linear

__all__ = ["DAPF", "ConvLayer", "FASSDNet", "HarDBlock", "MDA", "PyramBranch",
           "hard_block_link", "hard_block_out_ch"]

FIRST_CH = (16, 24, 32, 48)
CH_LIST = (64, 96, 160, 224, 320)
GRMUL = 1.7
GROWTH = (10, 16, 18, 24, 32)
N_LAYERS = (4, 4, 8, 8)
DAPF_RATES = (12, 24, 36)
DILATION_BLOCK = (2, 4, 8, 16)  # MDA at block i going up takes DILATION_BLOCK[i]


def hard_block_link(layer: int, base_ch: int, growth_rate: int, grmul: float):
    """(out channels, in channels, linked layers) of a HarDBlock's layer
    (F28:183-200): layer L links to L - 2^i for every 2^i dividing L, and
    its width grows by ``grmul`` per link beyond the first, rounded to even;
    layer 0 is the block's input. A copy of
    ``corrifnet_tpu/models/fassdnet.py:32-50``."""
    if layer == 0:
        return base_ch, 0, []
    out_channels = growth_rate
    link = []
    for i in range(10):
        dv = 2 ** i
        if layer % dv == 0:
            link.append(layer - dv)
            if i > 0:
                out_channels *= grmul
    out_channels = int(int(out_channels + 1) / 2) * 2
    in_channels = sum(hard_block_link(i, base_ch, growth_rate, grmul)[0] for i in link)
    return out_channels, in_channels, link


def hard_block_out_ch(in_channels, growth_rate, grmul, n_layers):
    """The channels a HarDBlock outputs: its odd layers' and its last's."""
    out = 0
    for i in range(n_layers):
        outch, _, _ = hard_block_link(i + 1, in_channels, growth_rate, grmul)
        if (i % 2 == 0) or (i == n_layers - 1):
            out += outch
    return out


class ConvLayer(nn.Module):
    """A bias-free conv (padding kernel // 2, PyTorch's default
    initializer), BatchNorm and ReLU (F28:167-178)."""

    def __init__(self, cin, cout, kernel=3, stride=1):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, kernel // 2, bias=False, dims=2,
                         kernel_init="torch_default")
        self.norm = BatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.norm(self.conv(x)))


class HarDBlock(nn.Module):
    """A HarDBlock (F28:203-242): each layer a 3x3 ConvLayer of the
    concatenation of the layers it links to, in link order; the output the
    concatenation of the odd layers and the last."""

    def __init__(self, in_channels, growth_rate, grmul, n_layers):
        super().__init__()
        self.links = []
        layers = []
        for i in range(n_layers):
            outch, inch, link = hard_block_link(i + 1, in_channels, growth_rate, grmul)
            self.links.append(link)
            layers.append(ConvLayer(inch, outch))
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        outs = [x]
        for layer, link in zip(self.layers, self.links):
            tin = [outs[j] for j in link]
            outs.append(layer(torch.cat(tin, dim=1) if len(tin) > 1 else tin[0]))
        t = len(outs)
        return torch.cat([outs[i] for i in range(t) if i == t - 1 or i % 2 == 1], dim=1)


def _kconv(cin, cout, kernel=1, padding=0, dilation=1):
    """A bias-free kaiming-normal conv (DAPF's)."""
    return Conv(cin, cout, kernel, 1, padding, bias=False, dims=2,
                kernel_init="kaiming_normal", dilation=dilation)


class PyramBranch(nn.Module):
    """A (3,1) conv dilated (d, 1), BatchNorm, ReLU, then a (1,3) conv
    dilated (1, d), BatchNorm, ReLU (F28:17-46)."""

    def __init__(self, inplanes, planes, d):
        super().__init__()
        self.atrous_conv3x1 = _kconv(inplanes, planes, (3, 1), (d, 0), (d, 1))
        self.bn3x1 = BatchNorm(planes)
        self.atrous_conv1x3 = _kconv(planes, planes, (1, 3), (0, d), (1, d))
        self.bn1x3 = BatchNorm(planes)

    def forward(self, x):
        x = torch.relu(self.bn3x1(self.atrous_conv3x1(x)))
        return torch.relu(self.bn1x3(self.atrous_conv1x3(x)))


class DAPF(nn.Module):
    """The dilated asymmetric pyramid (F28:48-92)."""

    def __init__(self, inplanes, alpha=2):
        super().__init__()
        mid = inplanes // alpha
        self.conv1x1 = _kconv(inplanes, mid)
        self.bn1x1 = BatchNorm(mid)
        for i, d in enumerate(DAPF_RATES):
            setattr(self, f"pyBranch{i + 2}", PyramBranch(inplanes, mid, d))
        self.conv1 = _kconv(mid * (1 + len(DAPF_RATES)), inplanes)
        self.bn1 = BatchNorm(inplanes)

    def forward(self, x):
        branches = [torch.relu(self.bn1x1(self.conv1x1(x)))]
        branches += [getattr(self, f"pyBranch{i + 2}")(x) for i in range(len(DAPF_RATES))]
        return torch.relu(self.bn1(self.conv1(torch.cat(branches, dim=1))))


class BNPReLU(nn.Module):
    """BatchNorm (eps 1e-3) and a per-channel PReLU named ``acti``
    (F28:99-108)."""

    def __init__(self, n):
        super().__init__()
        self.bn = BatchNorm(n, eps=1e-3)
        self.acti = PReLU(n)

    def forward(self, x):
        return self.acti(self.bn(x))


class _ConvBNPReLU(nn.Module):
    """A bias-free conv, then BNPReLU (F28:111-129)."""

    def __init__(self, cin, cout, kernel, padding, dilation=1):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, 1, padding, bias=False, dims=2,
                         kernel_init="torch_default", dilation=dilation)
        self.bn_prelu = BNPReLU(cout)

    def forward(self, x):
        return self.bn_prelu(self.conv(x))


class _Conv(nn.Module):
    """A bias-free 1x1 conv held as ``.conv``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=False, dims=2, kernel_init="torch_default")

    def forward(self, x):
        return self.conv(x)


class MDA(nn.Module):
    """The multi-resolution dilated asymmetric block (F28:132-163)."""

    def __init__(self, n_in, d=1):
        super().__init__()
        half = n_in // 2
        self.bn_relu_1 = BNPReLU(n_in)
        self.conv3x3 = _ConvBNPReLU(n_in, half, 3, 1)
        self.parallel_conv3x3 = _ConvBNPReLU(half, half, 3, 1)
        self.parallel_ddconv3x1 = _ConvBNPReLU(half, half, (3, 1), (d, 0), (d, 1))
        self.parallel_ddconv1x3 = _ConvBNPReLU(half, half, (1, 3), (0, d), (1, d))
        self.bn_relu_2 = BNPReLU(half)
        self.conv1x1 = _Conv(half, n_in)

    def forward(self, x):
        y = self.conv3x3(self.bn_relu_1(x))
        y = self.parallel_conv3x3(y) + self.parallel_ddconv1x3(self.parallel_ddconv3x1(y))
        return self.conv1x1(self.bn_relu_2(y)) + x


class FASSDNet(nn.Module):
    """Input (B, 3, H, W) (one modality); output sigmoid probabilities (B,
    1, H, W) in f32. FASSDNet has no dropout: ``transformer_dropout`` and
    ``set_dropout_rng`` have no effect."""

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1,
                 n_classes: int = 1, alpha: int = 2):
        super().__init__()
        del transformer_dropout
        self.compute_dtype = dtype
        base = [ConvLayer(3, FIRST_CH[0], 3, 2), ConvLayer(FIRST_CH[0], FIRST_CH[1], 3, 1),
                ConvLayer(FIRST_CH[1], FIRST_CH[2], 3, 2),
                ConvLayer(FIRST_CH[2], FIRST_CH[3], 3, 1)]
        ch, self.skip_ch = FIRST_CH[3], []
        blocks = len(N_LAYERS)
        for i in range(blocks):
            base.append(HarDBlock(ch, GROWTH[i], GRMUL, N_LAYERS[i]))
            ch = hard_block_out_ch(ch, GROWTH[i], GRMUL, N_LAYERS[i])
            self.skip_ch.append(ch)
            base.append(ConvLayer(ch, CH_LIST[i], 1))
            ch = CH_LIST[i]
            if i < blocks - 1:
                base.append(nn.Identity())  # the reference's AvgPool2d(2, 2)
        self.base = nn.ModuleList(base)
        self.DAPF = DAPF(ch, alpha)
        ups, mdas, dense = [], [], []
        for i in range(blocks - 2, -1, -1):
            cur = ch + self.skip_ch[i]
            ups.append(ConvLayer(cur, cur // 2, 1))
            mdas.append(MDA(cur // 2, DILATION_BLOCK[i]))
            dense.append(HarDBlock(cur // 2, GROWTH[i], GRMUL, N_LAYERS[i]))
            ch = hard_block_out_ch(cur // 2, GROWTH[i], GRMUL, N_LAYERS[i])
        self.conv1x1_up = nn.ModuleList(ups)
        self.mda = nn.ModuleList(mdas)
        self.denseBlocksUp = nn.ModuleList(dense)
        self.finalConv = Conv(ch, n_classes, 1, dims=2, kernel_init="torch_default")

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        kaiming-normal DAPF convs, PyTorch's default elsewhere, BatchNorm
        ones and zeros, PReLU slopes 0.25."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def set_dropout_rng(self, rng):
        """No dropout site: nothing to give."""
        return self

    def forward(self, x):
        y = x.to(self.compute_dtype)
        for stem in self.base[:4]:
            y = stem(y)
        skips = []
        blocks = len(N_LAYERS)
        for i in range(blocks):
            y = self.base[4 + 3 * i](y)
            if i < blocks - 1:
                skips.append(y)
            y = self.base[5 + 3 * i](y)
            if i < blocks - 1:
                y = avg_pool(y, (2, 2), (2, 2))
        y = self.DAPF(y)
        for up, mda, dense in zip(self.conv1x1_up, self.mda, self.denseBlocksUp):
            skip = skips.pop()
            y = resize_linear(y, skip.shape[2:], align_corners=True)
            y = dense(mda(up(torch.cat([y, skip], dim=1))))
        y = resize_linear(self.finalConv(y), x.shape[2:], align_corners=True)
        return torch.sigmoid(y.float())
