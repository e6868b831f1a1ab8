"""MMVit4, CorrIFNet (reference mmvit4.py:391-532), for inference and training.

Counterpart of ``corrifnet_tpu/models/mmvit4.py:117-248``, NCDHW inside:

  1. three inflated-ResNet50-3D encoders (RGB, NIR, SWIR), run in turn;
  2. early fusion per level (concat -> 1x1 conv -> ReLU -> InstanceNorm);
  3. per modality: a 1x1 conv to 512-d tokens (8^3 = 512 tokens), the
     IntraFormer (kernel K2) and the qkv projection;
  4. correlation fusion across the modalities (kernel K1), added onto the
     PRE-transformer skip tokens (mmvit4.py:505-507, quirk kept);
  5. the multimodal transformer over the 4 token groups (2048 tokens,
     kernel K2), the reinterpreting reshape (B, 2048, 512) -> (B, 8, 8, 8,
     2048) channels-last, and a 1x1 decode conv;
  6. DecoderFuse, depth-fused, to sigmoid probabilities (B, 3, 1, 224, 224):
     kernel K3 in the 15 RFM blocks, and in the 12 chain stages unless the
     lean backward runs there (``decoder_lean``; None: at batch <= 4).

In training mode (``module.train()``) BatchNorm runs on batch statistics
and the four transformers drop at ``transformer_dropout`` (0.1, the
reference's rate; 0 makes training deterministic), with the randomness of
the ``DropoutRng`` given to ``set_dropout_rng``; every kernel runs under
autograd (K1b and K2b in the backward).

``pallas_fused_blocks=True`` runs the 48 encoder bottlenecks through the
fused convolution kernels K4a-K4d (``models/resnet3d.py``); the parameters
and the ``state_dict`` are the same either way. So with the JAX model's
other levers (``corrifnet_tpu/models/mmvit4.py:93-115, 243-246``):
``fuse_expand_bn`` folds the bottlenecks' expanding BatchNorms into their
convs (``nn/fusedbn.py``; no effect with ``pallas_fused_blocks``),
``depth_mode='pruned'`` runs the depth-pruned decoder, ``decoder_remat``
rematerializes its chain stages and ``decoder_chunk`` depth-chunks its
level-1 and -2 lean stages (``models/decoder.py``). ``remat_mode`` (JAX's
default ``"all"``; ``"none"``, ``"early"``, ``"mid"``, ``"mid1"``)
rematerializes the encoders' tail blocks in the backward of a training
step, as the JAX model's packed stage 1 and encoders do
(``models/resnet3d.py``'s ``tail_remat``); it changes no bit of the step.

Parameters are f32; ``dtype`` is the compute dtype. Module names are the
reference's, so ``state_dict()`` is the reference layout (dead reference
parameters -- the per-modality decode convs and the decoder's unused
heads -- are left out, as ``corrifnet_tpu.models.torch_import`` leaves
them out). ``fusion5`` holds parameters but its output is unused by the
reference forward, so it is not computed.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.models.decoder import DecoderFuse
from corrifnet_tpu_torch.models.resnet3d import BASIC_DIMS, ResNet3DEncoder
from corrifnet_tpu_torch.nn import Conv, DropoutRng, EarlyFusionBlock, Transformer
from corrifnet_tpu_torch.ops import correlation_fusion

__all__ = ["MMVit4", "MODALITIES"]

MODALITIES = ("RGB", "NIR", "SWIR")
TRANSFORMER_DIM = 512  # mmvit4.py:11
PATCH = 8  # mmvit4.py:16
NUM_TOKENS = PATCH ** 3
_LEVEL_CHANNELS = (8, 16, 32, 64, 64, 64)  # encoder outputs a1..a5, x6


def _tokens(x):
    """(B, C, 8, 8, 8) -> channels-last tokens (B, 512, C)."""
    return x.flatten(2).transpose(1, 2)


class MMVit4(nn.Module):
    """Input (B, 3 modalities, 3 bands, H, W); output sigmoid probabilities
    (B, 3, 1, 224, 224) in f32."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 transformer_dropout: float = 0.1,
                 pallas_fused_blocks: bool = False,
                 decoder_lean: "bool | None" = None,
                 depth_mode: str = "full", fuse_expand_bn: bool = False,
                 decoder_remat: bool = False, decoder_chunk: int = 0,
                 remat_mode: str = "all"):
        super().__init__()
        self.compute_dtype = dtype
        dim = TRANSFORMER_DIM
        drop = transformer_dropout
        for m in MODALITIES:
            setattr(self, f"{m}_encoder", ResNet3DEncoder(pallas_fused_blocks, fuse_expand_bn,
                                                          remat_mode))
            setattr(self, f"{m}_encode_conv", Conv(BASIC_DIMS * 8, dim, 1))
            setattr(self, f"{m}_pos", nn.Parameter(torch.zeros(1, NUM_TOKENS, dim)))
            setattr(self, f"{m}_transformer", Transformer(dim, 1, 8, 512, drop))
            setattr(self, f"qkv_{m}", Conv(dim, dim * 3, 1))
        for i, c in enumerate(_LEVEL_CHANNELS):
            setattr(self, f"fusion{i + 1}", EarlyFusionBlock(3 * c))
        self.fused6_encode_conv = Conv(BASIC_DIMS * 8 * 3, dim, 1)
        self.fused6_pos = nn.Parameter(torch.zeros(1, NUM_TOKENS, dim))
        self.multimodal_transformer = Transformer(dim, 1, 8, 512, drop)
        self.multimodal_decode_conv = Conv(dim * 4, BASIC_DIMS * 8 * 3, 1)
        self.decoder_fuse = DecoderFuse(lean=decoder_lean, depth_mode=depth_mode,
                                        remat_convs=decoder_remat,
                                        c2_chunks=decoder_chunk)

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        kaiming-normal convs, PyTorch-default Linear layers, zero positional
        embeddings (mmvit4.py:408-411,437-439)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        with torch.no_grad():
            for m in MODALITIES:
                getattr(self, f"{m}_pos").zero_()
            self.fused6_pos.zero_()
        return self

    def set_remat_mode(self, mode: str):
        """The encoders' ``remat_mode`` (``ResNet3DEncoder.set_remat_mode``)."""
        for m in MODALITIES:
            getattr(self, f"{m}_encoder").set_remat_mode(mode)
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
        fused = {i: getattr(self, f"fusion{i + 1}")(*(lv[i] for lv in levels))
                 for i in (0, 1, 2, 3, 5)}

        pos = [getattr(self, f"{m}_pos").to(dt) for m in MODALITIES]
        skips, q, k, v = [], [], [], []
        for i, m in enumerate(MODALITIES):
            skip = getattr(self, f"{m}_encode_conv").pointwise(_tokens(levels[i][5]))
            trans = getattr(self, f"{m}_transformer")(skip, pos[i])
            qm, km, vm = getattr(self, f"qkv_{m}").pointwise(trans).chunk(3, dim=-1)
            skips.append(skip)
            q.append(qm)
            k.append(km)
            v.append(vm)
        corr = correlation_fusion(torch.stack(q), torch.stack(k), torch.stack(v))
        fused_tokens = torch.stack(skips) + corr

        fused6 = self.fused6_encode_conv.pointwise(_tokens(fused[5]))
        mm_tokens = torch.cat([*fused_tokens, fused6], dim=1)
        mm_pos = torch.cat([*pos, self.fused6_pos.to(dt)], dim=1)
        mm_out = self.multimodal_transformer(mm_tokens, mm_pos)
        # reinterpreting reshape: the (2048, 512) token buffer read row-major
        # as an 8^3 grid of 2048 channels (mmvit4.py:525-529)
        x6 = self.multimodal_decode_conv.pointwise(
            mm_out.reshape(b, NUM_TOKENS, TRANSFORMER_DIM * 4)
        )
        x6 = x6.transpose(1, 2).reshape(b, -1, PATCH, PATCH, PATCH)
        return self.decoder_fuse(fused[0], fused[1], fused[2], fused[3], x6)
