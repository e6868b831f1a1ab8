"""RobustMseg, style/content disentanglement segmentation (reference
RobustSeg.py:8-95), for inference and training.

Counterpart of ``corrifnet_tpu/models/robustseg.py``, NCHW inside:

  1. per modality (its three bands as channels, run in turn) a 4-level
     ``ContentEncoder`` of bias-free 3x3 convs and ReLU at 16/32/64/128
     channels, 224/112/56/28 wide, whose middle conv of each level drops
     whole (sample, channel) planes at rate 0.3 in training
     (``Dropout2d``); each level's first conv ``e{l}c1`` feeds both the
     chain and the residual (the reference applies it twice with shared
     weights: one value, used twice, here);
  2. the modality-drop mask: a modality whose input sums to exactly 0 (in
     f32, whatever the compute dtype) has its content zeroed, forward and
     backward;
  3. per level a sigmoid attention over the three modalities'
     concatenated content (``content_attn``), the weighted content fused by
     a 1x1 conv, InstanceNorm and ReLU (``content_share``);
  4. the ``MaskDecoder``: bilinear up-sampling (align_corners=False) and
     conv stages with the fused skips concatenated, a 1x1 conv to the mask
     logit, the sigmoid, repeated on the 3 modality channels.

The reference also runs a ``StyleEncoder`` per modality and three AdaIN
``ImageDecoder``s that reconstruct the modalities; nothing reads their
output (RobustSeg.py:95), so the JAX package's jitted step drops them and
their parameters get zero gradients. The port keeps their parameters, under
the reference's names, and does not compute them: the output and every
gradient are the same, and Adam leaves those parameters as they are on both
sides (``tests/test_torch_robustseg.py``). The JAX module's ``style_noise``
(off in ``_build_model``) replaces the style codes that only they read.

The JAX package builds RobustMseg with ``dtype`` alone and runs none of its
Pallas kernels on it. In ``notr`` runs the JAX package re-initializes its
4-axis conv kernels only (``corrifnet_tpu/nn/init.py``), which leaves out the
per-modality encoders, whose kernels it stacks to 5 axes:
``JAX_STACKED`` names them for ``nn.init.apply_reference_init_scheme``.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn import Conv, Dense, InstanceNorm, resize_linear

__all__ = ["RobustMseg"]

DROP_RATE = 0.3  # ContentEncoder's (RobustSeg.py:118-145)
NF = 16  # n_base_filters: the content levels' channels are NF, 2NF, 4NF, 8NF
STYLE_CH = 32  # the style encoder's base channels
MLP_CH = 128  # the reconstruction decoders' width


class BasicConv2d(nn.Module):
    """Bias-free conv [-> Dropout2d] [-> InstanceNorm] [-> ReLU]
    (RobustSeg.py:274-288). The dropout draws its (sample, channel) keep
    masks from the ``DropoutRng`` set on the model, never from the global
    generator."""

    def __init__(self, cin, cout, kernel=3, stride=1, padding=0, relu=True, norm=True,
                 drop_rate=0.0):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, padding, bias=False, dims=2,
                         kernel_init="torch_default")
        self.relu, self.drop_rate = relu, drop_rate
        self.norm = InstanceNorm() if norm else None
        self.rng = None

    def forward(self, x):
        x = self.conv(x)
        if self.drop_rate > 0 and self.training:
            if self.rng is None:
                raise RuntimeError(
                    "training RobustMseg needs set_dropout_rng(DropoutRng(seed, device))")
            keep = self.rng.keep(x[:, :, :1, :1], self.drop_rate)
            x = torch.where(keep, x / (1.0 - self.drop_rate), 0.0).to(x.dtype)
        if self.norm is not None:
            x = self.norm(x)
        return torch.relu(x) if self.relu else x


class StyleEncoder(nn.Module):
    """Parameters of the reference's StyleEncoder (RobustSeg.py:98-115)."""

    def __init__(self):
        super().__init__()
        b = STYLE_CH
        cfg = [(3, b, 7, 1, 3), (b, b * 2, 4, 2, 1), (b * 2, b * 4, 4, 2, 1),
               (b * 4, b * 4, 4, 2, 1), (b * 4, b * 4, 4, 2, 1)]
        self.encoder = nn.Sequential(*(BasicConv2d(ci, co, k, s, p, norm=False)
                                       for ci, co, k, s, p in cfg))
        self.final = BasicConv2d(b * 4, b * 4, 1, relu=False, norm=False)


class ContentEncoder(nn.Module):
    """The 4-level content encoder (RobustSeg.py:118-145)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for lvl in range(1, 5):
            ch = NF * 2 ** (lvl - 1)
            setattr(self, f"e{lvl}c1", BasicConv2d(cin, ch, 3, 1 if lvl == 1 else 2, 1,
                                                   norm=False))
            setattr(self, f"e{lvl}c2", BasicConv2d(ch, ch, 3, 1, 1, norm=False,
                                                   drop_rate=DROP_RATE))
            setattr(self, f"e{lvl}c3", BasicConv2d(ch, ch, 3, 1, 1, norm=False))
            cin = ch

    def forward(self, x):
        outs = []
        for lvl in range(1, 5):
            first = getattr(self, f"e{lvl}c1")(x)
            x = getattr(self, f"e{lvl}c3")(getattr(self, f"e{lvl}c2")(first)) + first
            outs.append(x)
        return outs


class _MLP(nn.Module):
    """MLP2d's parameters (RobustSeg.py:218-233)."""

    def __init__(self):
        super().__init__()
        for name in ("l1", "l2", "l_mu", "l_sigma"):
            setattr(self, name, Dense(MLP_CH, MLP_CH))


class _ResBlock(nn.Module):
    """AdaptiveRes2d's parameters (RobustSeg.py:247-265)."""

    def __init__(self):
        super().__init__()
        self.conv1 = BasicConv2d(MLP_CH, MLP_CH, 3, 1, 1, relu=False, norm=False)
        self.conv2 = BasicConv2d(MLP_CH, MLP_CH, 3, 1, 1, relu=False, norm=False)


class ImageDecoder(nn.Module):
    """The parameters of a reconstruction decoder (RobustSeg.py:148-178):
    the style MLP, four AdaIN residual blocks, three up-sampling stages (the
    conv at Sequential index 1) and the 7x7 output conv."""

    def __init__(self):
        super().__init__()
        self.mlp = _MLP()
        self.res_blocks = nn.ModuleList([_ResBlock() for _ in range(4)])
        self.up_blocks = nn.ModuleList(
            [nn.Sequential(nn.Identity(), BasicConv2d(MLP_CH >> i, MLP_CH >> (i + 1), 5, 1, 2,
                                                      relu=False, norm=False))
             for i in range(3)])
        self.final = BasicConv2d(MLP_CH >> 3, 3, 7, 1, 3, relu=False, norm=False)


class MaskDecoder(nn.Module):
    """The segmentation decoder (RobustSeg.py:181-213) over the fused
    levels (NF, 2NF, 4NF, 8NF channels), to one mask logit."""

    def __init__(self):
        super().__init__()
        c = cin = NF * 8
        for g, ch in (("c3", c // 2), ("c2", c // 4), ("c1", c // 8)):
            setattr(self, f"{g}_1", BasicConv2d(cin, ch, 3, 1, 1))
            setattr(self, f"{g}_2", BasicConv2d(ch, ch, 3, 1, 1))
            setattr(self, f"{g}_3", BasicConv2d(ch, ch, 1))
            cin = 2 * ch
        self.final = BasicConv2d(cin, 1, 1, relu=False, norm=False)

    def forward(self, feats):
        x = feats[3]
        for g, skip in (("c3", feats[2]), ("c2", feats[1]), ("c1", feats[0])):
            x = resize_linear(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=False)
            for i in (1, 2, 3):
                x = getattr(self, f"{g}_{i}")(x)
            x = torch.cat([x, skip], dim=1)
        return self.final(x)


class RobustMseg(nn.Module):
    """Input (B, 3 modalities, 3 bands, H, W); output sigmoid probabilities
    (B, 3, 1, H, W) in f32. In training mode the content encoders drop at
    rate 0.3 with the randomness of the ``DropoutRng`` given to
    ``set_dropout_rng``."""

    # the per-modality modules that the JAX package stacks on a modality axis
    JAX_STACKED = ("style_enc_list.", "content_enc_list.")

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1):
        super().__init__()
        del transformer_dropout  # RobustMseg has no transformer; its dropout rate is fixed
        self.compute_dtype = dtype
        self.style_enc_list = nn.ModuleList([StyleEncoder() for _ in range(3)])
        self.content_enc_list = nn.ModuleList([ContentEncoder() for _ in range(3)])
        self.content_attn = nn.ModuleList(
            [BasicConv2d(3 * NF * 2 ** lvl, 3, 3, 1, 1, relu=False) for lvl in range(4)])
        self.content_share = nn.ModuleList(
            [BasicConv2d(3 * NF * 2 ** lvl, NF * 2 ** lvl, 1) for lvl in range(4)])
        self.recon_decoders = nn.ModuleList([ImageDecoder() for _ in range(3)])
        self.seg_decoder = MaskDecoder()

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        PyTorch's default conv and Linear initializers (the JAX modules')."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def set_dropout_rng(self, rng):
        """Give the content encoders' Dropout2d the randomness of its masks."""
        for module in self.modules():
            if isinstance(module, BasicConv2d):
                module.rng = rng
        return self

    def forward(self, x):
        b, m = x.shape[:2]
        dt = self.compute_dtype
        # modality-drop detection (RobustSeg.py:214), summed in f32
        keep = x.reshape(b, m, -1).float().sum(dim=2) != 0  # (B, M)
        xm = x.to(dt)
        contents = [enc(xm[:, i]) for i, enc in enumerate(self.content_enc_list)]
        shared = []
        for lvl in range(4):
            # ZeroLayer: a dropped modality's content is zeroed, forward and backward
            feats = [contents[i][lvl] * keep[:, i, None, None, None].to(dt) for i in range(m)]
            attn = self.content_attn[lvl](torch.cat(feats, dim=1))
            attn = torch.sigmoid(attn.float()).to(dt)
            weighted = torch.cat([f * attn[:, i:i + 1] for i, f in enumerate(feats)], dim=1)
            shared.append(self.content_share[lvl](weighted))
        mask = torch.sigmoid(self.seg_decoder(shared).float())  # (B, 1, H, W)
        return mask[:, None].repeat(1, 3, 1, 1, 1)
