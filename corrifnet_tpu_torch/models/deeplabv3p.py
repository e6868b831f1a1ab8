"""DeepLabV3+ with an aligned-Xception backbone (reference
F14_DEEPLABV3PLUS_V4_xception.py:445-494), for inference and training, on
the 4-D input path.

Counterpart of ``corrifnet_tpu/models/deeplabv3p.py``, NCHW, with the
reference ``state_dict`` layout that
``corrifnet_tpu.models.torch_import.deeplab_variables_from_state_dict``
reads: ``xception_features.{conv1,bn1,conv2,bn2}``, each Xception block's
``rep.{pos}`` Sequential with its ReLUs counted in the indexing (a
separable conv's ``conv1`` and ``pointwise``, the BatchNorm after it),
``skip``/``skipbn``, ``conv{3,4,5}``/``bn{3,4,5}``; ``aspp{i}``'s
``atrous_convolution`` and ``batch_norm``, ``image_pool.1``, ``fc1.{0,1}``,
``reduce_conv2.{0,1}`` and ``last_conv.{0,1,4,5,8}``:

  * the backbone (F14:111-229) at output stride 16: entry conv1/conv2,
    blocks 1-3 at stride 2, 16 middle blocks at 728 channels, block20, three
    dilated (rate 2) separable convs to 2048 channels with BatchNorm and
    ReLU. Separable convs are a bias-free depthwise 3x3 with TF's fixed
    padding (symmetric for k=3, so the conv's own padding) and a bias-free
    1x1; every backbone conv is kaiming-normal initialized (fan-in);
  * the two in-place ReLU quirks the JAX package keeps: a block whose
    ``rep`` starts with a ReLU feeds ``relu(inp)`` to its skip, and the
    low-level feature is ``relu(block1_out)``;
  * the head (F14:451-494): ASPP at rates 1/6/12/18 (3x3, padding = rate,
    BatchNorm, no ReLU) and a global *max* pool branch (its gradient shared
    by ties, as JAX's reduce-max), a 1x1 conv and a nearest resize back;
    fc1 (1x1 over 1280 channels, BatchNorm, ReLU, dropout) and a bilinear x4
    (``align_corners=False``); the low-level branch reduced to 48 channels
    (BatchNorm, ReLU, dropout); the 304 concatenated through two 3x3 convs
    (BatchNorm, ReLU, dropout), the classifier, a bilinear x4 and the
    sigmoid in f32.

The four dropout sites drop elements at a fixed 0.5, with masks from the
``DropoutRng`` given to ``set_dropout_rng``, in the JAX module's order (fc1,
reduce, last0, last1). ``pretrained`` and ``small`` are accepted and have no
effect, as in the JAX package (the reference's pretrained weights are
absent). The JAX package builds the model with ``dtype`` alone and runs
none of its Pallas kernels on it.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn import BatchNorm, Conv, resize_linear, resize_nearest

__all__ = ["DeepLabV3Plus", "SeparableConvSame", "XBlock", "Xception", "XCEPTION_BLOCKS",
           "rep_layout"]

DROP_RATE = 0.5  # every dropout site's (F14:461-475)
ASPP_RATES = (1, 6, 12, 18)

# Xception's blocks (F14:170-205): name -> (planes, reps, stride, start_with_relu,
# grow_first, is_last)
XCEPTION_BLOCKS = {
    "block1": (128, 2, 2, False, True, False),
    "block2": (256, 2, 2, True, True, False),
    "block3": (728, 2, 2, True, True, True),
    **{f"block{i}": (728, 3, 1, True, True, False) for i in range(4, 20)},
    "block20": (1024, 2, 1, True, False, True),
}


def _kconv(cin, cout, kernel=1, stride=1, padding=0, dilation=1, groups=1):
    """A bias-free kaiming-normal conv of the backbone."""
    return Conv(cin, cout, kernel, stride, padding, bias=False, dims=2,
                kernel_init="kaiming_normal", groups=groups, dilation=dilation)


def _conv(cin, cout, kernel=1, padding=0, dilation=1):
    """A head conv: PyTorch's default initializer, with bias."""
    return Conv(cin, cout, kernel, 1, padding, dims=2, kernel_init="torch_default",
                dilation=dilation)


def rep_layout(reps, stride=1, start_with_relu=True, grow_first=True, is_last=False):
    """The kinds of a block's ``rep`` Sequential in order, its ReLUs
    included ('relu', 'sep', 'bn'; F14:70-91): the indexing of the
    reference's ``state_dict`` keys, and the order of the block's ops. The
    trailing strided or last sep conv is bare."""
    seq = ["relu", "sep", "bn"] * reps
    if not start_with_relu:
        seq = seq[1:]
    if stride != 1 or is_last:
        seq.append("sep")
    return seq


class SeparableConvSame(nn.Module):
    """A bias-free depthwise 3x3 with stride and dilation, padded as TF's
    ``fixed_padding`` (F14:29-35: ``rate`` on each side for k=3), then a
    bias-free 1x1 (F14:38-51)."""

    def __init__(self, cin, planes, stride=1, dilation=1):
        super().__init__()
        self.conv1 = _kconv(cin, cin, 3, stride, dilation, dilation, groups=cin)
        self.pointwise = _kconv(cin, planes)

    def forward(self, x):
        return self.pointwise(self.conv1(x))


class XBlock(nn.Module):
    """An Xception block (F14:54-108) of ``rep_layout``'s ops: each sep conv
    grows to ``planes`` first (``grow_first``) or last, the middle ones keep
    the width; a strided block ends in a bare stride-2 sep conv, a last
    block in a bare stride-1 one. ReLUs are ``nn.Identity`` placeholders."""

    def __init__(self, cin, planes, reps, stride=1, start_with_relu=True, grow_first=True,
                 is_last=False, dilation=1):
        super().__init__()
        self.kinds = rep_layout(reps, stride, start_with_relu, grow_first, is_last)
        seps = [planes if grow_first and i == 0 or not grow_first and i == reps - 1 else None
                for i in range(reps)]
        mods, width, j = [], cin, 0
        for kind in self.kinds:
            if kind == "relu":
                mods.append(nn.Identity())
            elif kind == "bn":
                mods.append(BatchNorm(width))
            elif j < reps:  # a sep conv of the rep proper
                out = seps[j] or width
                mods.append(SeparableConvSame(width, out, 1, dilation))
                width, j = out, j + 1
            else:  # the bare trailing one
                mods.append(SeparableConvSame(width, planes, stride, 1))
        self.rep = nn.Sequential(*mods)
        if planes != cin or stride != 1:
            self.skip = _kconv(cin, planes, 1, stride)
            self.skipbn = BatchNorm(planes)
        else:
            self.skip = None

    def forward(self, x):
        y = x
        for kind, mod in zip(self.kinds, self.rep):
            y = torch.relu(y) if kind == "relu" else mod(y)
        # the reference's leading nn.ReLU(inplace=True) rewrites the block's
        # input before the skip reads it (F14:94-107)
        inp = torch.relu(x) if self.kinds[0] == "relu" else x
        skip = inp if self.skip is None else self.skipbn(self.skip(inp))
        return y + skip


class Xception(nn.Module):
    """Aligned Xception at output stride 16 (F14:111-229); returns (the
    2048-channel features, the low-level feature relu(block1_out))."""

    def __init__(self):
        super().__init__()
        self.conv1 = _kconv(3, 32, 3, 2, 1)
        self.bn1 = BatchNorm(32)
        self.conv2 = _kconv(32, 64, 3, 1, 1)
        self.bn2 = BatchNorm(64)
        width = 64
        for name, (planes, reps, stride, swr, grow, last) in XCEPTION_BLOCKS.items():
            setattr(self, name, XBlock(width, planes, reps, stride, swr, grow, last))
            width = planes
        for i, ch in ((3, 1536), (4, 1536), (5, 2048)):
            setattr(self, f"conv{i}", SeparableConvSame(width, ch, 1, 2))
            setattr(self, f"bn{i}", BatchNorm(ch))
            width = ch

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.block1(y)
        # block1's output aliases the low-level feature, which block2's
        # leading in-place ReLU then rewrites (F14:188-190)
        low = torch.relu(y)
        for name in list(XCEPTION_BLOCKS)[1:]:
            y = getattr(self, name)(y)
        for i in (3, 4, 5):
            y = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y)))
        return y, low


class _ASPP(nn.Module):
    def __init__(self, cin, planes, rate):
        super().__init__()
        self.atrous_convolution = _conv(cin, planes, 3, rate, rate)
        self.batch_norm = BatchNorm(planes)

    def forward(self, x):
        return self.batch_norm(self.atrous_convolution(x))


class DeepLabV3Plus(nn.Module):
    """Input (B, 3, H, W) (one modality, H and W multiples of 16); output
    sigmoid probabilities (B, 1, H, W) in f32. In training mode its four
    dropout sites drop at 0.5 with the randomness of the ``DropoutRng`` given
    to ``set_dropout_rng``. ``transformer_dropout`` has no effect: the rate
    is fixed."""

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1,
                 num_classes: int = 1, small: bool = True, pretrained: bool = False):
        super().__init__()
        del transformer_dropout, small, pretrained  # no effect, as in the JAX package
        self.compute_dtype = dtype
        self.rng = None
        self.xception_features = Xception()
        for i, rate in enumerate(ASPP_RATES):
            setattr(self, f"aspp{i + 1}", _ASPP(2048, 256, rate))
        self.image_pool = nn.Sequential(nn.Identity(), _conv(2048, 256))
        self.fc1 = nn.Sequential(_conv(1280, 256), BatchNorm(256))
        self.reduce_conv2 = nn.Sequential(_conv(128, 48), BatchNorm(48))
        self.last_conv = nn.Sequential(
            _conv(304, 256, 3, 1), BatchNorm(256), nn.Identity(), nn.Identity(),
            _conv(256, 256, 3, 1), BatchNorm(256), nn.Identity(), nn.Identity(),
            _conv(256, num_classes))

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        kaiming-normal backbone convs, PyTorch's default head convs,
        BatchNorm ones and zeros."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def set_dropout_rng(self, rng):
        """Give the four dropout sites the randomness of their masks."""
        self.rng = rng
        return self

    def _drop(self, x):
        if not self.training:
            return x
        if self.rng is None:
            raise RuntimeError(
                "training DeepLabv3_plus needs set_dropout_rng(DropoutRng(seed, device))")
        return torch.where(self.rng.keep(x, DROP_RATE), x / (1.0 - DROP_RATE),
                           torch.zeros_like(x))

    def forward(self, x):
        feat, low = self.xception_features(x.to(self.compute_dtype))
        branches = [getattr(self, f"aspp{i + 1}")(feat) for i in range(len(ASPP_RATES))]
        pool = self.image_pool[1](feat.amax(dim=(2, 3), keepdim=True))
        branches.append(resize_nearest(pool, feat.shape[2:]))
        f = self._drop(torch.relu(self.fc1[1](self.fc1[0](torch.cat(branches, dim=1)))))
        f = resize_linear(f, (f.shape[2] * 4, f.shape[3] * 4), align_corners=False)
        lo = self._drop(torch.relu(self.reduce_conv2[1](self.reduce_conv2[0](low))))
        f = torch.cat([f, lo], dim=1)
        c = self.last_conv
        for i in (0, 4):
            f = self._drop(torch.relu(c[i + 1](c[i](f))))
        f = c[8](f)
        f = resize_linear(f, (f.shape[2] * 4, f.shape[3] * 4), align_corners=False)
        return torch.sigmoid(f.float())
