"""ENet (reference F29_ENet.py:278-438), for inference and training, on the
4-D input path.

Counterpart of ``corrifnet_tpu/models/enet.py``, NCHW, with the reference
``state_dict`` layout that
``corrifnet_tpu.models.torch_import.enet_variables_from_state_dict`` reads
(``initial_block.{main_branch,batch_norm,out_prelu}``, each bottleneck's
``ext_conv{1,2,3}`` Sequentials of conv, BatchNorm and activation,
``main_conv1`` in an up-sampling one, ``out_prelu``, and
``transposed_conv``):

  * the initial block: a stride-2 3x3 conv to 13 channels beside a 3x3
    stride-2 max pool of the input (``max_pool``: a tie goes to one entry,
    as the JAX ``max_pool`` gives it), concatenated, BatchNorm, activation;
  * stage 1: a down-sampling bottleneck to 64 channels and four regular
    ones, dropout 0.01; stages 2 and 3: a down-sampling bottleneck to 128
    channels (stage 2 only) and eight bottlenecks each, regular, dilated at
    2, 4, 8 and 16 and asymmetric (5x1 then 1x5), dropout 0.1;
  * the decoder: an up-sampling bottleneck to 64 channels and two regular
    ones, an up-sampling one to 16 and one regular; dropout 0.1;
  * a 3x3 stride-2 transposed conv (``output_padding`` 1) to the class and
    the sigmoid in f32. The reference's forward computes this and does not
    return it (F29:435-437); the JAX package returns it (its registry's
    note: "canonical ENet, WITH the return the reference forward lost"),
    and so does the port.

A down-sampling bottleneck's main branch is ``max_pool_argmax`` (k=3,
stride 2, padding 1; its gradient spread evenly over tied entries, as the
JAX package's ``jnp.max`` spreads it) with its channels zero-padded; an
up-sampling one's is a 1x1 conv and BatchNorm placed by ``max_unpool`` at
the indices of the matching down-sampling bottleneck (the last writer
wins where indices repeat; every writer gets the gradient). Each
bottleneck's extension branch ends in Dropout2d, whose (sample, channel)
keep masks come from the ``DropoutRng`` given to ``set_dropout_rng``.

The activation: the encoder's is PReLU, the decoder's ReLU
(``encoder_relu=False``, ``decoder_relu=True``), and the reference builds
ONE activation module per bottleneck (F29:48-51) and uses it after every
BatchNorm of the block and on its output: one PReLU slope per encoder
bottleneck (and the initial block's). The port registers that one module
in each place, so its ``state_dict`` holds the slope under every key the
reference's holds (``ext_conv1.2.weight``, ..., ``out_prelu.weight``) and
the optimizer sees one parameter. The reference's ``project_layer`` is dead
(F29:414-415) and is not built, as in the JAX package. Every conv keeps
PyTorch's default initializer. The JAX package builds ENet with ``dtype``
alone and runs none of its Pallas kernels on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.nn import (
    BatchNorm,
    Conv,
    ConvTranspose,
    PReLU,
    max_pool,
    max_pool_argmax,
    max_unpool,
)

__all__ = ["DownsamplingBottleneck", "ENet", "InitialBlock", "RegularBottleneck",
           "UpsamplingBottleneck", "STAGE23"]

# a stage-2/3 bottleneck: (reference name at stage s and index i, kwargs)
STAGE23 = (("regular{s}_{i}", {}),
           ("dilated{s}_{i}", {"dilation": 2, "padding": 2}),
           ("asymmetric{s}_{i}", {"kernel_size": 5, "padding": 2, "asymmetric": True}),
           ("dilated{s}_{i}", {"dilation": 4, "padding": 4}),
           ("regular{s}_{i}", {}),
           ("dilated{s}_{i}", {"dilation": 8, "padding": 8}),
           ("asymmetric{s}_{i}", {"kernel_size": 5, "padding": 2, "asymmetric": True}),
           ("dilated{s}_{i}", {"dilation": 16, "padding": 16}))


def _conv(cin, cout, kernel=1, stride=1, padding=0, dilation=1):
    return Conv(cin, cout, kernel, stride, padding, bias=False, dims=2,
                kernel_init="torch_default", dilation=dilation)


def _act(relu):
    """The activation module a bottleneck shares: ReLU, or one PReLU slope."""
    return nn.ReLU() if relu else PReLU()


class _Dropout2d(nn.Module):
    """Dropout2d at ``rate``: whole (sample, channel) maps, the keep mask
    drawn at (B, C, 1, 1) from the model's ``DropoutRng``."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate
        self.rng = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rng is None:
            raise RuntimeError("training ENet needs set_dropout_rng(DropoutRng(seed, device))")
        keep = self.rng.keep(x[:, :, :1, :1], self.rate)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class InitialBlock(nn.Module):
    """conv(3 -> 13, stride 2) beside max_pool(3, stride 2) of the input,
    concatenated, BatchNorm, activation (F29:9-39)."""

    def __init__(self, cin=3, cout=16, relu=False):
        super().__init__()
        self.main_branch = _conv(cin, cout - cin, 3, 2, 1)
        self.batch_norm = BatchNorm(cout)
        self.out_prelu = _act(relu)

    def forward(self, x):
        ext = max_pool(x, (3, 3), (2, 2), (1, 1))
        return self.out_prelu(self.batch_norm(torch.cat([self.main_branch(x), ext], dim=1)))


class RegularBottleneck(nn.Module):
    """1x1 reduction, a k x k conv (dilated) or a k x 1 then 1 x k pair
    (asymmetric), 1x1 expansion, each with BatchNorm and the shared
    activation; Dropout2d; the input added and the activation (F29:42-117)."""

    def __init__(self, channels, internal_ratio=4, kernel_size=3, padding=0, dilation=1,
                 asymmetric=False, dropout_prob=0.0, relu=True):
        super().__init__()
        internal = channels // internal_ratio
        act = _act(relu)
        self.ext_conv1 = nn.Sequential(_conv(channels, internal), BatchNorm(internal), act)
        k, p = kernel_size, padding
        if asymmetric:
            self.ext_conv2 = nn.Sequential(
                _conv(internal, internal, (k, 1), 1, (p, 0), dilation), BatchNorm(internal),
                act, _conv(internal, internal, (1, k), 1, (0, p), dilation),
                BatchNorm(internal), act)
        else:
            self.ext_conv2 = nn.Sequential(_conv(internal, internal, k, 1, p, dilation),
                                           BatchNorm(internal), act)
        self.ext_conv3 = nn.Sequential(_conv(internal, channels), BatchNorm(channels), act)
        self.ext_regul = _Dropout2d(dropout_prob)
        self.out_prelu = act

    def forward(self, x):
        ext = self.ext_regul(self.ext_conv3(self.ext_conv2(self.ext_conv1(x))))
        return self.out_prelu(x + ext)


class DownsamplingBottleneck(nn.Module):
    """Main branch: ``max_pool_argmax`` (k, stride 2, padding), its channels
    zero-padded to ``out_channels``; extension: a 2x2 stride-2 conv, a k x k
    conv and a 1x1 conv, each with BatchNorm and the shared activation, and
    Dropout2d; the sum's activation and the pool's indices (F29:120-191)."""

    def __init__(self, in_channels, out_channels, internal_ratio=4, kernel_size=3,
                 padding=0, dropout_prob=0.0, relu=True):
        super().__init__()
        internal = in_channels // internal_ratio
        self.kernel_size, self.padding = kernel_size, padding
        act = _act(relu)
        self.ext_conv1 = nn.Sequential(_conv(in_channels, internal, 2, 2),
                                       BatchNorm(internal), act)
        self.ext_conv2 = nn.Sequential(_conv(internal, internal, kernel_size, 1, padding),
                                       BatchNorm(internal), act)
        self.ext_conv3 = nn.Sequential(_conv(internal, out_channels),
                                       BatchNorm(out_channels), act)
        self.ext_regul = _Dropout2d(dropout_prob)
        self.out_prelu = act

    def forward(self, x):
        main, indices = max_pool_argmax(x, self.kernel_size, 2, self.padding)
        ext = self.ext_regul(self.ext_conv3(self.ext_conv2(self.ext_conv1(x))))
        main = F.pad(main, (0, 0, 0, 0, 0, ext.shape[1] - main.shape[1]))
        return self.out_prelu(main + ext), indices


class UpsamplingBottleneck(nn.Module):
    """Main branch: a 1x1 conv and BatchNorm, then ``max_unpool`` at the
    down-sampling bottleneck's indices; extension: a 1x1 conv, a k x k
    stride-2 transposed conv (``output_padding`` 1) and a 1x1 conv, each
    with BatchNorm and the shared activation, and Dropout2d; the sum's
    activation (F29:194-275)."""

    def __init__(self, in_channels, out_channels, internal_ratio=4, kernel_size=3,
                 padding=0, dropout_prob=0.0, relu=True):
        super().__init__()
        internal = in_channels // internal_ratio
        act = _act(relu)
        self.main_conv1 = nn.Sequential(_conv(in_channels, out_channels),
                                        BatchNorm(out_channels))
        self.ext_conv1 = nn.Sequential(_conv(in_channels, internal), BatchNorm(internal), act)
        self.ext_conv2 = nn.Sequential(
            ConvTranspose(internal, internal, kernel_size, 2, padding, 1, bias=False),
            BatchNorm(internal), act)
        self.ext_conv3 = nn.Sequential(_conv(internal, out_channels),
                                       BatchNorm(out_channels), act)
        self.ext_regul = _Dropout2d(dropout_prob)
        self.out_prelu = act

    def forward(self, x, indices, out_hw):
        main = max_unpool(self.main_conv1(x), indices, out_hw)
        ext = self.ext_regul(self.ext_conv3(self.ext_conv2(self.ext_conv1(x))))
        return self.out_prelu(main + ext)


class ENet(nn.Module):
    """Input (B, 3, H, W) (one modality, H and W multiples of 8); output
    sigmoid probabilities (B, 1, H, W) in f32. In training mode every
    bottleneck's Dropout2d drops (at 0.01 in stage 1, 0.1 elsewhere) with
    the randomness of the ``DropoutRng`` given to ``set_dropout_rng``.
    ``transformer_dropout`` has no effect: the rates are fixed."""

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1,
                 classes: int = 1, encoder_relu: bool = False, decoder_relu: bool = True):
        super().__init__()
        del transformer_dropout  # ENet has no transformer; its dropout rates are fixed
        self.compute_dtype = dtype
        er, dr = encoder_relu, decoder_relu
        self.initial_block = InitialBlock(3, 16, relu=er)
        self.downsample1_0 = DownsamplingBottleneck(16, 64, padding=1, dropout_prob=0.01,
                                                    relu=er)
        for i in range(1, 5):
            setattr(self, f"regular1_{i}",
                    RegularBottleneck(64, padding=1, dropout_prob=0.01, relu=er))
        self.downsample2_0 = DownsamplingBottleneck(64, 128, padding=1, dropout_prob=0.1,
                                                    relu=er)
        self.stage23 = []
        for stage, first in ((2, 1), (3, 0)):
            for j, (name, kwargs) in enumerate(STAGE23):
                name = name.format(s=stage, i=first + j)
                kwargs = {"padding": 1, **kwargs}
                setattr(self, name, RegularBottleneck(128, dropout_prob=0.1, relu=er,
                                                      **kwargs))
                self.stage23.append(name)
        self.upsample4_0 = UpsamplingBottleneck(128, 64, padding=1, dropout_prob=0.1,
                                                relu=dr)
        self.regular4_1 = RegularBottleneck(64, padding=1, dropout_prob=0.1, relu=dr)
        self.regular4_2 = RegularBottleneck(64, padding=1, dropout_prob=0.1, relu=dr)
        self.upsample5_0 = UpsamplingBottleneck(64, 16, padding=1, dropout_prob=0.1,
                                                relu=dr)
        self.regular5_1 = RegularBottleneck(16, padding=1, dropout_prob=0.1, relu=dr)
        self.transposed_conv = ConvTranspose(16, classes, 3, 2, 1, 1, bias=False)

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        PyTorch's default convs and transposed convs, BatchNorm ones and
        zeros, PReLU slopes 0.25."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def set_dropout_rng(self, rng):
        """Give every Dropout2d the randomness of its masks."""
        for module in self.modules():
            if isinstance(module, _Dropout2d):
                module.rng = rng
        return self

    def forward(self, x):
        y = self.initial_block(x.to(self.compute_dtype))
        hw1 = y.shape[2:]
        y, idx1 = self.downsample1_0(y)
        for i in range(1, 5):
            y = getattr(self, f"regular1_{i}")(y)
        hw2 = y.shape[2:]
        y, idx2 = self.downsample2_0(y)
        for name in self.stage23:
            y = getattr(self, name)(y)
        y = self.regular4_2(self.regular4_1(self.upsample4_0(y, idx2, hw2)))
        y = self.regular5_1(self.upsample5_0(y, idx1, hw1))
        return torch.sigmoid(self.transposed_conv(y).float())
