"""ELANet, the efficient lightweight attention network (reference
F30_ELANet.py:252-342), for inference and training, on the 4-D input path.

Counterpart of ``corrifnet_tpu/models/elanet.py``, NCHW, with the reference
``state_dict`` layout that
``corrifnet_tpu.models.torch_import.elanet_variables_from_state_dict``
reads (``level1_{i}``, ``b1``, ``level2_0``, ``level2.{i}``,
``bn_prelu_2``, ``level3_0``, ``level3.{i}``, ``bn_prelu_3``, ``decode``
with ``Xd1.{0,1,2}``, ``Xd2``, ``Xd2_1.{0,1,2}``, ``Xb_1.0``, ``CA``,
``SA.conv.{0,1,2,3}`` and ``bnpre``, ``classifier.0``):

  * a stride-2 stem of three ConvBNPReLU (F30:258-260) and a BNPReLU;
  * stage 2: an ECG_D down-sampler and M=2 ECG_R blocks at dilation 2;
    stage 3: an ECG_D and 2N-1=9 ECG_R blocks at dilations 4 (x5), 8 (x4)
    (F30:77-147, 276-278); each stage's output and its down-sampler's are
    concatenated and go through a BNPReLU;
  * the RFF decoder (F30:201-240): the stem's and stage 2's maps fused at
    stride 4, stage 3's map by a 1x1 conv and a bilinear resize
    (``align_corners=False``), CCA channel and SCA spatial attention;
  * element dropout at 0.5 on the decoder's output, a bias-free 1x1
    classifier, a bilinear resize to the input (``align_corners=False``) and
    the sigmoid in f32.

Every BatchNorm has eps 1e-3 (F30:15) and every PReLU one slope per
channel. CCA is a 1-D conv over the pooled channel descriptor, its kernel,
stride and padding set by the channel counts (F30:165-181), bias-free and in
f32, its weights ``CA.conv.0`` and ``CA.conv.2`` (1, 1, k) with PyTorch's
default initializer; every 2-D conv is kaiming-normal initialized
(F30:290-295).

The compute dtype follows the JAX module's: every conv and every
BatchNorm's output is in the compute dtype, but CCA's f32 attention promotes
``j * ca`` (ECG_D) and ``x1 * CCA(x1)`` (ECG_R), so under bf16 the stage-2
and stage-3 residual stream (each ECG_D's and ECG_R's output) and the
decoder's channel-attended half are f32 until the next conv or BatchNorm.
The JAX package builds ELANet with ``dtype`` alone and runs none of its
Pallas kernels on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.nn import BatchNorm, Conv, PReLU, resize_linear
from corrifnet_tpu_torch.nn.init import torch_default_

__all__ = ["BNPReLU", "CCA", "ConvBNPReLU", "ECG_D", "ECG_R", "ELANet", "RFF", "SCA",
           "WDConv"]

BN_EPS = 1e-3  # every BatchNorm's (F30:15)
DROP_RATE = 0.5  # the decoder output's dropout (F30:283)
STAGE3_DILATIONS = (4, 4, 4, 4, 4, 8, 8, 8, 8)  # F30:276-278


def _kconv(cin, cout, kernel=1, stride=1, padding=0, dilation=1, groups=1, bias=False):
    """A kaiming-normal 2-D conv."""
    return Conv(cin, cout, kernel, stride, padding, bias=bias, dims=2,
                kernel_init="kaiming_normal", groups=groups, dilation=dilation)


class C(nn.Module):
    """A bias-free conv held as ``.conv`` (the reference's C and channelwise
    conv wrappers, F30:40-75), its input cast to the compute dtype."""

    def __init__(self, cin, cout, kernel=1, dilation=1, groups=1):
        super().__init__()
        self.conv = _kconv(cin, cout, kernel, 1, ((kernel - 1) // 2) * dilation, dilation,
                           groups)

    def forward(self, x, dt):
        return self.conv(x.to(dt))


def _cw_conv(n, k, dilation=1):
    """The channelwise (depthwise) conv, bias-free (F30:52-75)."""
    return C(n, n, k, dilation, groups=n)


class BNPReLU(nn.Module):
    """BatchNorm (eps 1e-3), its output in the compute dtype, then PReLU."""

    def __init__(self, n):
        super().__init__()
        self.bn = BatchNorm(n, eps=BN_EPS)
        self.act = PReLU(n)

    def forward(self, x, dt):
        return self.act(self.bn(x, dt))


class ConvBNPReLU(BNPReLU):
    """A bias-free k x k conv with padding (k - 1) // 2, then BNPReLU
    (F30:9-23)."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cout)
        self.conv = _kconv(cin, cout, k, stride, (k - 1) // 2)

    def forward(self, x, dt):
        return super().forward(self.conv(x.to(dt)), dt)


class _Taps(nn.Module):
    """One bias-free Conv1d weight, (1, 1, k), with PyTorch's default
    initializer."""

    def __init__(self, k):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, 1, k))

    def reset_parameters(self, generator):
        torch_default_(self.weight, self.weight.shape[2], generator)


class CCA(nn.Module):
    """ECA-style channel attention (F30:165-181): the channel descriptor
    (the mean over H and W) as a length-``inchannel`` signal, a Conv1d of
    kernel inchannel / 8 - 1 and stride inchannel / outchannel, ReLU, a
    second Conv1d at stride 1, sigmoid; in f32. Returns (B, outchannel, 1,
    1) f32 weights."""

    def __init__(self, inchannel, outchannel):
        super().__init__()
        k = inchannel // 8 - 1
        self.stride = inchannel // outchannel
        self.pad = (inchannel // 8 - 2) // 2
        self.conv = nn.Sequential(_Taps(k), nn.Identity(), _Taps(k))

    def forward(self, x):
        d = x.mean(dim=(2, 3)).float().unsqueeze(1)  # (B, 1, C)
        y = torch.relu(F.conv1d(d, self.conv[0].weight.float(), None, self.stride,
                                self.pad))
        y = torch.sigmoid(F.conv1d(y, self.conv[2].weight.float(), None, 1, self.pad))
        return y.view(y.shape[0], -1, 1, 1)


class SCA(nn.Module):
    """Spatial attention (F30:184-197): 1x1 ConvBNPReLU to inchannel / 16,
    a 7x7 channelwise conv, BNPReLU, a 1x1 conv with bias to outchannel,
    the sigmoid in f32, returned in the compute dtype."""

    def __init__(self, inchannel, outchannel):
        super().__init__()
        c = inchannel // 16
        self.conv = nn.ModuleList([ConvBNPReLU(inchannel, c, 1), _cw_conv(c, 7), BNPReLU(c),
                                   _kconv(c, outchannel, bias=True)])

    def forward(self, x, dt):
        c = self.conv
        y = c[3](c[2](c[1](c[0](x, dt), dt), dt))
        return torch.sigmoid(y.float()).to(y.dtype)


class ECG_D(nn.Module):
    """The down-sampling ECG block (F30:77-108): a stride-2 3x3 ConvBNPReLU,
    a 1x1 one, local and dilated channelwise 3x3 convs concatenated,
    BatchNorm and PReLU, a 1x1 reduction, and CCA's channel weights (f32)."""

    def __init__(self, cin, n_out, dilation_rate=2):
        super().__init__()
        self.conv1x1 = ConvBNPReLU(cin, n_out, 3, 2)
        self.conv1 = ConvBNPReLU(n_out, n_out, 1, 1)
        self.F_loc = _cw_conv(n_out, 3)
        self.F_sur = _cw_conv(n_out, 3, dilation_rate)
        self.bn = BatchNorm(2 * n_out, eps=BN_EPS)
        self.act = PReLU(2 * n_out)
        self.reduce = C(2 * n_out, n_out)
        self.CA = CCA(n_out, n_out)

    def forward(self, x, dt):
        y = self.conv1(self.conv1x1(x, dt), dt)
        j = torch.cat([self.F_loc(y, dt), self.F_sur(y, dt)], dim=1)
        j = self.reduce(self.act(self.bn(j, dt)), dt)
        return j * self.CA(j)


class ECG_R(nn.Module):
    """The residual ECG block (F30:111-147): the input concatenated with the
    sum of local and dilated channelwise convs of its 1x1 reduction,
    BNPReLU, CCA's weights; a second 1x1 reduction, the two convs
    concatenated, BNPReLU, a 1x1 ConvBNPReLU; the input added."""

    def __init__(self, n_in, n_out, dilation_rate=2):
        super().__init__()
        n = n_out // 2
        self.conv1x1 = ConvBNPReLU(n_in, n, 1)
        self.F_loc1 = _cw_conv(n, 3)
        self.F_sur1 = _cw_conv(n, 3, dilation_rate)
        self.bn_prelu1 = BNPReLU(n_in + n)
        self.CA = CCA(n_in + n, n_in + n)
        self.conv1 = ConvBNPReLU(n_in + n, n, 1)
        self.F_loc2 = _cw_conv(n, 3)
        self.F_sur2 = _cw_conv(n, 3, dilation_rate)
        self.bn_prelu2 = BNPReLU(n_out)
        self.conv2 = ConvBNPReLU(n_out, n_out, 1)

    def forward(self, x, dt):
        y = self.conv1x1(x, dt)
        x1 = torch.cat([x, self.F_loc1(y, dt) + self.F_sur1(y, dt)], dim=1)
        x1 = self.bn_prelu1(x1, dt)
        x1 = x1 * self.CA(x1)
        x2 = self.conv1(x1, dt)
        x3 = torch.cat([self.F_loc2(x2, dt), self.F_sur2(x2, dt)], dim=1)
        return x + self.conv2(self.bn_prelu2(x3, dt), dt)


class WDConv(nn.Module):
    """A bias-free k x k channelwise conv with stride, then BNPReLU
    (F30:150-162)."""

    def __init__(self, n, k, stride=1):
        super().__init__()
        self.conv = _kconv(n, n, k, stride, (k - 1) // 2, groups=n)
        self.bnpre = BNPReLU(n)

    def forward(self, x, dt):
        return self.bnpre(self.conv(x.to(dt)), dt)


class RFF(nn.Module):
    """The multi-scale fusion decoder (F30:201-240): the stem's map by a
    stride-2 WDConv, a 1x1 conv and BNPReLU, added to stage 2's by a WDConv,
    then a WDConv, a 1x1 conv and BNPReLU; stage 3's by a 1x1 conv resized
    to it; the two concatenated give CCA's (f32) and SCA's weights, each half
    scaled by one plus its weights, concatenated again, BNPReLU."""

    def __init__(self, inchann=32, outchann=128, k=3, xb_channels=256):
        super().__init__()
        c = inchann
        self.Xd1 = nn.ModuleList([WDConv(c, k, 2), _kconv(c, 2 * c, bias=True),
                                  BNPReLU(2 * c)])
        self.Xd2 = WDConv(2 * c, k, 1)
        self.Xd2_1 = nn.ModuleList([WDConv(2 * c, k, 1), _kconv(2 * c, 2 * c, bias=True),
                                    BNPReLU(2 * c)])
        self.Xb_1 = nn.ModuleList([_kconv(xb_channels, 2 * c, bias=True)])
        self.CA = CCA(4 * c, 2 * c)
        self.SA = SCA(4 * c, 2 * c)
        self.bnpre = BNPReLU(outchann)

    def forward(self, xd1, xd2, xb, dt):
        a = self.Xd1
        d1 = a[2](a[1](a[0](xd1, dt)), dt)
        a = self.Xd2_1
        d2 = a[2](a[1](a[0](d1 + self.Xd2(xd2, dt), dt)), dt)
        b = resize_linear(self.Xb_1[0](xb.to(dt)), d2.shape[2:], align_corners=False)
        xcat = torch.cat([b, d2], dim=1)
        ca, sa = self.CA(xcat), self.SA(xcat, dt)
        out = torch.cat([b * (sa + 1), d2 * (ca + 1)], dim=1)
        return self.bnpre(out, dt)


class ELANet(nn.Module):
    """Input (B, 3, H, W) (one modality); output sigmoid probabilities (B,
    1, H, W) in f32. In training mode the decoder's output drops at 0.5 with
    the randomness of the ``DropoutRng`` given to ``set_dropout_rng``.
    ``transformer_dropout`` has no effect: the rate is fixed."""

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1,
                 classes: int = 1, M: int = 2, N: int = 5):
        super().__init__()
        del transformer_dropout  # ELANet has no transformer; its dropout rate is fixed
        self.compute_dtype = dtype
        self.rng = None
        self.level1_0 = ConvBNPReLU(3, 32, 3, 2)
        self.level1_1 = ConvBNPReLU(32, 32, 3, 1)
        self.level1_2 = ConvBNPReLU(32, 32, 3, 1)
        self.b1 = BNPReLU(32)
        self.level2_0 = ECG_D(32, 64, 2)
        self.level2 = nn.ModuleList([ECG_R(64, 64, 2) for _ in range(M)])
        self.bn_prelu_2 = BNPReLU(128)
        self.level3_0 = ECG_D(128, 128, 4)
        self.level3 = nn.ModuleList([ECG_R(128, 128, STAGE3_DILATIONS[i])
                                     for i in range(2 * N - 1)])
        self.bn_prelu_3 = BNPReLU(256)
        self.decode = RFF(32, 128, 3)
        self.classifier = nn.ModuleList([C(128, classes)])

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        kaiming-normal 2-D convs, PyTorch's default CCA taps, BatchNorm ones
        and zeros, PReLU slopes 0.25."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def set_dropout_rng(self, rng):
        """Give the dropout site the randomness of its masks."""
        self.rng = rng
        return self

    def _drop(self, x):
        if not self.training:
            return x
        if self.rng is None:
            raise RuntimeError("training ELANet needs set_dropout_rng(DropoutRng(seed, device))")
        return torch.where(self.rng.keep(x, DROP_RATE), x / (1.0 - DROP_RATE),
                           torch.zeros_like(x))

    def forward(self, x):
        dt = self.compute_dtype
        y0 = self.level1_2(self.level1_1(self.level1_0(x, dt), dt), dt)
        y0_cat = self.b1(y0, dt)
        y1_0 = self.level2_0(y0_cat, dt)
        y1 = y1_0
        for block in self.level2:
            y1 = block(y1, dt)
        y1_cat = self.bn_prelu_2(torch.cat([y1, y1_0], dim=1), dt)
        y2_0 = self.level3_0(y1_cat, dt)
        y2 = y2_0
        for block in self.level3:
            y2 = block(y2, dt)
        y2_cat = self.bn_prelu_3(torch.cat([y2_0, y2], dim=1), dt)
        out = self._drop(self.decode(y0_cat, y1, y2_cat, dt))
        out = resize_linear(self.classifier[0](out, dt), x.shape[2:], align_corners=False)
        return torch.sigmoid(out.float())
