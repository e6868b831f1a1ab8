"""MMVit2 and its correlation-free ablation mmformer (reference
mmmvit2.py:345-477, mmformer.py:349-435), for inference and training.

Counterpart of ``corrifnet_tpu/models/mmvit2.py``, NCDHW inside:

  1. per modality (RGB, NIR, SWIR, run in turn) a ``ConvEncoder``: a bare
     replicate-padded 3^3 conv, then 14 ``GeneralConv3d`` (conv -> ReLU ->
     InstanceNorm, the epilogue kernel K3) in five residual stages, the last
     four downsampling by 2 in every dimension, depth too; its x6 is every
     level nearest-resized to 8^3, concatenated (184 channels) and a 1x1
     conv to 64;
  2. the skips: each level's three modalities stacked on the channels
     (24/48/96/192 channels at depths 3/2/1/1);
  3. per modality a 1x1 conv to 512-d tokens (8^3 = 512 tokens), the
     IntraFormer (kernel K2) and, for MMVit2, the qkv projection;
  4. MMVit2: correlation fusion across the modalities (kernel K1), whose
     output REPLACES the intra tokens (mmmvit2.py:457-461); mmformer: the
     intra tokens go on as they are;
  5. the multimodal transformer over the 3 token groups (1536 tokens,
     kernel K2), the reinterpreting reshape (B, 1536, 512) -> (B, 8, 8, 8,
     1536) channels-last, and a 1x1 decode conv to 192;
  6. ``DecoderFuse(use_reduce=False)``: MMVit4's decoder without
     ``RFM5_reduce``, lean by the JAX package's batch rule (B <= 4).

No BatchNorm: every norm is a parameter-free InstanceNorm. The JAX package
builds these models with ``dtype``, ``use_pallas`` and ``depth_mode`` only
(``corrifnet_tpu/run/main.py:48-67``); ``depth_mode='pruned'`` runs the
depth-pruned decoder (``models/decoder.py``), as there; MMVit4's other
options have no effect on them there, nor here (``models/registry.py``).

Parameters are f32; ``dtype`` is the compute dtype. Module names are the
reference's, so ``state_dict()`` is the layout that
``corrifnet_tpu.models.torch_import.mmvit2_variables_from_state_dict``
reads; mmformer's has no ``qkv_{m}``, as the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.models.decoder import DecoderFuse
from corrifnet_tpu_torch.models.mmvit4 import MODALITIES, NUM_TOKENS, PATCH, TRANSFORMER_DIM
from corrifnet_tpu_torch.nn import Conv, DropoutRng, GeneralConv3d, Transformer, resize_nearest
from corrifnet_tpu_torch.ops import correlation_fusion

__all__ = ["ConvEncoder", "MMFormer", "MMVit2"]

BD = 8  # basic_dims (mmmvit2.py:11)
_STAGES = (("e1", BD, 1), ("e2", BD * 2, 2), ("e3", BD * 4, 2), ("e4", BD * 8, 2),
           ("e5", BD * 8, 2))


def _tokens(x):
    """(B, C, 8, 8, 8) -> channels-last tokens (B, 512, C)."""
    return x.flatten(2).transpose(1, 2)


class ConvEncoder(nn.Module):
    """The reference's conv Encoder (mmmvit2.py:57-104). Input (B, 1, 3, H,
    W), one modality's bands as depth; returns the five levels x1..x5 at
    8/16/32/64/64 channels and the bottleneck x6 (B, 64, 8, 8, 8)."""

    def __init__(self):
        super().__init__()
        cin = 1
        for name, ch, stride in _STAGES:
            if name == "e1":
                self.e1_c1 = Conv(1, ch, 3, 1, 1, padding_mode="replicate")
            else:
                setattr(self, f"{name}_c1",
                        GeneralConv3d(cin, ch, 3, stride, 1, padding_mode="replicate"))
            for c in ("c2", "c3"):
                setattr(self, f"{name}_{c}",
                        GeneralConv3d(ch, ch, 3, 1, 1, padding_mode="replicate"))
            cin = ch
        self.conv = Conv(sum(ch for _, ch, _ in _STAGES), BD * 8, 1)

    def forward(self, x):
        levels = []
        for name, _, _ in _STAGES:
            y = getattr(self, f"{name}_c1")(x)
            x = y + getattr(self, f"{name}_c3")(getattr(self, f"{name}_c2")(y))
            levels.append(x)
        pooled = torch.cat([resize_nearest(t, (PATCH,) * 3) for t in levels], dim=1)
        return (*levels, self.conv(pooled))


class MMVit2(nn.Module):
    """Input (B, 3 modalities, 3 bands, H, W); output sigmoid probabilities
    (B, 3, 1, 224, 224) in f32. ``use_correlation=False`` is mmformer.

    In training mode (``module.train()``) the four transformers drop at
    ``transformer_dropout`` (0.1, the reference's rate; 0 makes training
    deterministic), with the randomness of the ``DropoutRng`` given to
    ``set_dropout_rng``; every kernel runs under autograd."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 transformer_dropout: float = 0.1, use_correlation: bool = True,
                 depth_mode: str = "full"):
        super().__init__()
        self.compute_dtype = dtype
        self.use_correlation = use_correlation
        dim, drop = TRANSFORMER_DIM, transformer_dropout
        for m in MODALITIES:
            setattr(self, f"{m}_encoder", ConvEncoder())
            setattr(self, f"{m}_encode_conv", Conv(BD * 8, dim, 1))
            setattr(self, f"{m}_pos", nn.Parameter(torch.zeros(1, NUM_TOKENS, dim)))
            setattr(self, f"{m}_transformer", Transformer(dim, 1, 8, 512, drop))
            if use_correlation:
                setattr(self, f"qkv_{m}", Conv(dim, dim * 3, 1))
        self.multimodal_transformer = Transformer(dim, 1, 8, 512, drop)
        self.multimodal_decode_conv = Conv(dim * 3, BD * 8 * 3, 1)
        self.decoder_fuse = DecoderFuse(use_reduce=False, depth_mode=depth_mode)

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        kaiming-normal convs and 1x1 projections, PyTorch-default Linear
        layers, zero positional embeddings (the JAX modules' initializers)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        with torch.no_grad():
            for m in MODALITIES:
                getattr(self, f"{m}_pos").zero_()
        return self

    def set_dropout_rng(self, rng: DropoutRng):
        """Give the four transformers the randomness of their dropout."""
        for module in self.modules():
            if isinstance(module, Transformer):
                module.set_dropout_rng(rng)
        return self

    def forward(self, x):
        b = x.shape[0]
        dt = self.compute_dtype
        x = x.to(dt)
        levels = [getattr(self, f"{m}_encoder")(x[:, i:i + 1])
                  for i, m in enumerate(MODALITIES)]
        # stacked per-modality skips (mmmvit2.py:416-427)
        skips = [torch.cat([lv[i] for lv in levels], dim=1) for i in range(4)]

        pos = [getattr(self, f"{m}_pos").to(dt) for m in MODALITIES]
        groups, q, k, v = [], [], [], []
        for i, m in enumerate(MODALITIES):
            tok = getattr(self, f"{m}_encode_conv").pointwise(_tokens(levels[i][5]))
            intra = getattr(self, f"{m}_transformer")(tok, pos[i])
            groups.append(intra)
            if self.use_correlation:
                qm, km, vm = getattr(self, f"qkv_{m}").pointwise(intra).chunk(3, dim=-1)
                q.append(qm)
                k.append(km)
                v.append(vm)
        if self.use_correlation:
            # the correlation output replaces the intra tokens
            groups = correlation_fusion(torch.stack(q), torch.stack(k), torch.stack(v))

        mm_out = self.multimodal_transformer(torch.cat(list(groups), dim=1),
                                             torch.cat(pos, dim=1))
        # reinterpreting reshape: the (1536, 512) token buffer read row-major
        # as an 8^3 grid of 1536 channels (mmmvit2.py:470)
        x6 = self.multimodal_decode_conv.pointwise(
            mm_out.reshape(b, NUM_TOKENS, TRANSFORMER_DIM * 3))
        x6 = x6.transpose(1, 2).reshape(b, -1, PATCH, PATCH, PATCH)
        return self.decoder_fuse(*skips, x6)


class MMFormer(MMVit2):
    """mmformer (mmformer.py:349-435): MMVit2 without the correlation stage."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 transformer_dropout: float = 0.1, depth_mode: str = "full"):
        super().__init__(dtype, transformer_dropout, use_correlation=False,
                         depth_mode=depth_mode)
