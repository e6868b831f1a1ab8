"""UNetV2, the dropout-modified classic UNet (reference F9_UNET_V2_3.py),
for inference and training: the port's first model on the 4-D input path.

Counterpart of ``corrifnet_tpu/models/unet.py``, NCHW, with the reference
``state_dict`` layout that
``corrifnet_tpu.models.torch_import.unetv2_variables_from_state_dict``
reads (``inc.conv.conv``, ``down{i}.mpconv.2.conv``, ``up{i}.conv.conv``,
``outc.conv``; ``nn.Identity`` placeholders keep the Sequential indices of
the reference's pooling, dropout and ReLU):

  * ``inc``: DoubleConv (3x3 conv, BatchNorm, ReLU, twice) 3 -> 64;
  * four down paths: 2x2 max pool, element dropout at 0.5, DoubleConv to
    128, 256, 512, 512;
  * four up paths: bilinear x2 with aligned corners, zero padding to the
    skip's size where they differ, the skip and it concatenated, dropout at
    0.5, DoubleConv to 256, 128, 64, 64;
  * ``outc``: a 1x1 conv to the one class, then the sigmoid in f32:
    (B, 1, H, W).

The eight dropout sites draw their masks from the ``DropoutRng`` given to
``set_dropout_rng``, in the JAX module's order. The reference's
ConvTranspose2d branch is dead (``bilinear=True``) and is left out, as in
the JAX package. The JAX package builds UNetV2 with ``dtype`` alone and
runs none of its Pallas kernels on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.nn import BatchNorm, Conv, max_pool, resize_linear

__all__ = ["UNetV2"]

DROP_RATE = 0.5  # every dropout site's (F9:49-56, 80-92)


def _conv(cin, cout, kernel):
    return Conv(cin, cout, kernel, 1, kernel // 2, dims=2, kernel_init="torch_default")


class DoubleConv(nn.Module):
    """(3x3 conv -> BatchNorm -> ReLU) * 2 (F9:19-37), as the reference's
    ``conv`` Sequential (the convs at 0 and 3, the BatchNorms at 1 and 4)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(_conv(cin, cout, 3), BatchNorm(cout), nn.Identity(),
                                  _conv(cout, cout, 3), BatchNorm(cout), nn.Identity())

    def forward(self, x):
        c = self.conv
        return torch.relu(c[4](c[3](torch.relu(c[1](c[0](x))))))


class _Inconv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = DoubleConv(cin, cout)


class _Down(nn.Module):
    """The reference's ``mpconv`` = (MaxPool2d(2), Dropout(0.5), double_conv)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.mpconv = nn.Sequential(nn.Identity(), nn.Identity(), DoubleConv(cin, cout))


class _Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = DoubleConv(cin, cout)


class _Outconv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _conv(cin, cout, 1)


class UNetV2(nn.Module):
    """Input (B, 3, H, W) (one modality); output sigmoid probabilities
    (B, 1, H, W) in f32. In training mode its eight dropout sites
    drop at 0.5 with the randomness of the ``DropoutRng`` given to
    ``set_dropout_rng``. ``transformer_dropout`` has no effect: UNetV2's
    rate is fixed."""

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1):
        super().__init__()
        del transformer_dropout  # UNetV2 has no transformer; its dropout rate is fixed
        self.compute_dtype = dtype
        self.rng = None
        self.inc = _Inconv(3, 64)
        chans = (64, 128, 256, 512, 512)
        for i in range(4):
            setattr(self, f"down{i + 1}", _Down(chans[i], chans[i + 1]))
        for i, (cin, cout) in enumerate(((1024, 256), (512, 128), (256, 64), (128, 64))):
            setattr(self, f"up{i + 1}", _Up(cin, cout))
        self.outc = _Outconv(64, 1)

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        PyTorch's default conv initializer, BatchNorm ones and zeros."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def set_dropout_rng(self, rng):
        """Give the eight dropout sites the randomness of their masks."""
        self.rng = rng
        return self

    def _drop(self, x):
        if not self.training:
            return x
        if self.rng is None:
            raise RuntimeError("training UNetV2 needs set_dropout_rng(DropoutRng(seed, device))")
        return torch.where(self.rng.keep(x, DROP_RATE), x / (1.0 - DROP_RATE),
                           torch.zeros_like(x))

    def forward(self, x):
        feats = [self.inc.conv(x.to(self.compute_dtype))]
        for i in range(1, 5):
            d = self._drop(max_pool(feats[-1], (2, 2)))
            feats.append(getattr(self, f"down{i}").mpconv[2](d))
        u = feats[4]
        for i, skip in zip(range(1, 5), feats[3::-1]):
            u = resize_linear(u, (u.shape[2] * 2, u.shape[3] * 2), align_corners=True)
            dh, dw = skip.shape[2] - u.shape[2], skip.shape[3] - u.shape[3]
            if dh or dw:
                u = F.pad(u, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            u = getattr(self, f"up{i}").conv(self._drop(torch.cat([skip, u], dim=1)))
        return torch.sigmoid(self.outc.conv(u).float())
