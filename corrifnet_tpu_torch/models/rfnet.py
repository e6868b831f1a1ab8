"""RFNet, region-aware modal fusion (reference RFNet.py:287-317), for
inference and training.

Counterpart of ``corrifnet_tpu/models/rfnet.py``, NCDHW inside:

  1. per modality (RGB, NIR, SWIR, run in turn) a 4-stage residual
     ``ConvEncoder4``: replicate-padded 3^3 convs, each followed by the plain
     InstanceNorm and LeakyReLU(0.2) (``GeneralConv3d(order='norm_act',
     act='lrelu')``), the last three stages downsampling by 2 in every
     dimension, depth too: x1..x4 at 8/16/32/64 channels, depths 3/2/1/1,
     224/112/56/28 wide;
  2. per level a probability region map from a ``PrmGenerator``, whose
     softmax runs over its single class channel and is therefore constantly 1
     (a quirk the JAX package keeps), and whose output is detached (the JAX
     package's ``stop_gradient``): its parameters get no gradient, and it
     runs without autograd;
  3. per level a ``RegionAwareModalFusion``: the modalities gated by the
     map, weighted by a sigmoid of their pooled features, then a region
     fusion and a shortcut of 1x1 -> 3^3 -> 1x1 convs;
  4. the decode cascade to fixed volumes whatever the input size: 16^3
     (nearest), 32^3, 64^3 and 128^3 (trilinear, align_corners=True), the
     level's fused features nearest-resized to the running volume and
     concatenated;
  5. a 1x1 conv to one logit, trilinear to (1, 224, 224) (depth row 0), the
     sigmoid, repeated on the 3 modality channels.

The JAX package builds RFNet with ``dtype`` alone
(``corrifnet_tpu/run/main.py:48-67``) and runs none of its Pallas kernels
on it: every op here is PyTorch's, on the card as on the CPU. Module names
are the reference's, so ``state_dict()`` is the layout that
``corrifnet_tpu.models.torch_import.rfnet_variables_from_state_dict``
reads.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.models.mmvit4 import MODALITIES
from corrifnet_tpu_torch.nn import Conv, GeneralConv3d, resize_linear, resize_nearest

__all__ = ["RFNet"]

BD = 8  # basic_dims (RFNet.py:156)
NUM_CLS = 1  # the region maps' and the output's class channels


def _gconv(cin, cout, k, stride=1):
    """RFNet's general_conv3d: replicate pad, conv, InstanceNorm, LeakyReLU(0.2)."""
    return GeneralConv3d(cin, cout, k, stride, 1 if k == 3 else 0, padding_mode="replicate",
                         order="norm_act", act="lrelu")


def _modality_concat(stack):
    """(B, 3, C, D, H, W) -> (B, 3C, D, H, W), modality-major channels."""
    return stack.flatten(1, 2)


class ConvEncoder4(nn.Module):
    """The 4-stage residual encoder (RFNet.py:157-190), channels 8/16/32/64.
    Input (B, 1, 3, H, W), one modality's bands as depth."""

    def __init__(self):
        super().__init__()
        cin = 1
        for s, (ch, stride) in enumerate([(BD, 1), (BD * 2, 2), (BD * 4, 2), (BD * 8, 2)], 1):
            setattr(self, f"e{s}_c1", _gconv(cin, ch, 3, stride))
            setattr(self, f"e{s}_c2", _gconv(ch, ch, 3))
            setattr(self, f"e{s}_c3", _gconv(ch, ch, 3))
            cin = ch

    def forward(self, x):
        feats = []
        for s in range(1, 5):
            x = getattr(self, f"e{s}_c1")(x)
            x = x + getattr(self, f"e{s}_c3")(getattr(self, f"e{s}_c2")(x))
            feats.append(x)
        return feats


class PrmGenerator(nn.Module):
    """prm_generator (RFNet.py:58-79), or prm_generator_laststage
    (RFNet.py:35-56, ``last=True``): the modalities' features embedded by
    1x1 -> 3^3 -> 1x1 convs, for the other stages resized to the running
    volume and concatenated with it, then a 1x1 conv to 16 channels, a 1x1
    conv to the class channel and a softmax over it."""

    def __init__(self, in_channel: int, last: bool = False):
        super().__init__()
        c = in_channel
        self.last = last
        self.embedding_layer = nn.Sequential(
            _gconv(3 * c, c // 4, 1), _gconv(c // 4, c // 4, 3), _gconv(c // 4, c, 1))
        self.prm_layer = nn.Sequential(_gconv(c if last else 2 * c, 16, 1),
                                       Conv(16, NUM_CLS, 1))

    def forward(self, stack, running=None):
        y = self.embedding_layer(_modality_concat(stack))
        if not self.last:
            y = torch.cat([running, resize_linear(y, running.shape[2:])], dim=1)
        p = self.prm_layer(y)
        return torch.softmax(p.float(), dim=1).to(p.dtype)


class _ModalFusion(nn.Module):
    """modal_fusion's weight layer (RFNet.py:81-106): 1x1 conv, LeakyReLU(0.2),
    1x1 conv, on the (B, 3C + 1) pooled vector."""

    def __init__(self, in_channel: int):
        super().__init__()
        self.weight_layer = nn.Sequential(Conv(3 * in_channel + 1, 128, 1),
                                          nn.LeakyReLU(0.2), Conv(128, 3, 1))


class _RegionFusion(nn.Module):
    """region_fusion (RFNet.py:109-120): 1x1 -> 3^3 -> 1x1 to C/2."""

    def __init__(self, in_channel: int):
        super().__init__()
        c = in_channel
        self.fusion_layer = nn.Sequential(_gconv(c, c, 1), _gconv(c, c, 3),
                                          _gconv(c, c // 2, 1))


class RegionAwareModalFusion(nn.Module):
    """region_aware_modal_fusion (RFNet.py:122-154) on the modalities'
    features (B, 3, C, D, H, W) and the level's region map (B, 1, D, H, W)."""

    def __init__(self, in_channel: int):
        super().__init__()
        c = in_channel
        self.modal_fusion = _ModalFusion(c)
        self.region_fusion = _RegionFusion(c)
        self.short_cut = nn.Sequential(_gconv(3 * c, c, 1), _gconv(c, c, 3),
                                       _gconv(c, c // 2, 1))

    def forward(self, stack, prm):
        b = stack.shape[0]
        gated = stack * prm[:, None]
        prm_avg = prm.mean(dim=(2, 3, 4)) + 1e-7  # (B, 1)
        feat_avg = gated.mean(dim=(3, 4, 5)) / prm_avg[:, :, None]  # (B, 3, C)
        vec = torch.cat([feat_avg.reshape(b, -1), prm_avg], dim=1)
        w = self.modal_fusion.weight_layer(vec[:, :, None, None, None])
        w = torch.sigmoid(w.float()).to(stack.dtype).view(b, 3, 1, 1, 1, 1)
        # the weighted sum runs over the GATED features (RFNet.py:106,147-149)
        region = (gated * w).sum(dim=1)
        return torch.cat([self.region_fusion.fusion_layer(region),
                          self.short_cut(_modality_concat(stack))], dim=1)


class _DecoderFuse(nn.Module):
    """The reference's ``decoder_fuse`` (RFNet.py:193-282): the region map
    generators, the fusions and the decode cascade."""

    def __init__(self):
        super().__init__()
        self.prm_generator4 = PrmGenerator(BD * 8, last=True)
        for i, c in ((3, BD * 4), (2, BD * 2), (1, BD)):
            setattr(self, f"prm_generator{i}", PrmGenerator(c))
        for i, c in ((4, BD * 8), (3, BD * 4), (2, BD * 2), (1, BD)):
            setattr(self, f"RFM{i}", RegionAwareModalFusion(c))
        for lvl, c in ((3, BD * 4), (2, BD * 2), (1, BD)):
            setattr(self, f"d{lvl}_c1", _gconv(2 * c, c, 3))
            setattr(self, f"d{lvl}_c2", _gconv(2 * c, c, 3))
            setattr(self, f"d{lvl}_out", _gconv(c, c, 1))
        self.seg_layer = Conv(BD, NUM_CLS, 1)

    def forward(self, x1, x2, x3, x4):
        with torch.no_grad():  # the region maps are detached (stop_gradient)
            prm = self.prm_generator4(x4)
        run = self.RFM4(x4, prm)
        run = resize_linear(resize_nearest(run, (16,) * 3), (32,) * 3)
        run = self.d3_c1(run)
        for lvl, stack, size in ((3, x3, 32), (2, x2, 64), (1, x1, 128)):
            with torch.no_grad():
                prm = getattr(self, f"prm_generator{lvl}")(stack, run)
                prm = resize_linear(prm, stack.shape[3:])
            fused = resize_nearest(getattr(self, f"RFM{lvl}")(stack, prm), (size,) * 3)
            run = getattr(self, f"d{lvl}_c2")(torch.cat([fused, run], dim=1))
            run = getattr(self, f"d{lvl}_out")(run)
            if lvl > 1:
                run = getattr(self, f"d{lvl - 1}_c1")(resize_linear(run, (2 * size,) * 3))
        logits = resize_linear(self.seg_layer(run), (1, 224, 224))
        return torch.sigmoid(logits.float())


class RFNet(nn.Module):
    """Input (B, 3 modalities, 3 bands, H, W); output sigmoid probabilities
    (B, 3, 1, 224, 224) in f32, whatever H and W. No dropout and no
    BatchNorm: training mode computes what eval mode does."""

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1):
        super().__init__()
        del transformer_dropout  # RFNet has no transformer
        self.compute_dtype = dtype
        for m in MODALITIES:
            setattr(self, f"{m}_encoder", ConvEncoder4())
        self.decoder_fuse = _DecoderFuse()

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        kaiming-normal conv kernels, PyTorch-default biases (the JAX
        modules' initializers)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def set_dropout_rng(self, rng):
        """RFNet draws no randomness."""
        return self

    def forward(self, x):
        x = x.to(self.compute_dtype)
        levels = [getattr(self, f"{m}_encoder")(x[:, i:i + 1])
                  for i, m in enumerate(MODALITIES)]
        stacks = [torch.stack([lv[i] for lv in levels], dim=1) for i in range(4)]
        pred = self.decoder_fuse(*stacks)
        return pred.repeat(1, 3, 1, 1, 1)
