"""Decoder_fuse, the full-depth multiscale decoder (reference mmvit4.py:222-292).

Counterpart of ``DecoderFuse`` in ``corrifnet_tpu/models/decoder.py`` at
``depth_mode='full'``. At each level an RFM block refines the early-fused
skip; the running state is up-sampled x2 (trilinear, align_corners=True)
into a replicate-padded 3^3 conv; the skip is resized to the running grid
with nearest interpolation, concatenated and convolved, then a 1^3 conv.
Depth grows 8 -> 16 -> 32 -> 64 -> 128. The head keeps depth slice 0 only
(``up_to_224`` with align_corners=True and output depth 1 samples source
depth 0, mmvit4.py:263).

``use_reduce`` (MMVit4's ``RFM5_reduce``, a 1x1 conv 192 -> 128 after
``RFM5``) is off for MMVit2 and mmformer, whose ``d4_c1`` takes the 192
channels of ``RFM5`` directly (``corrifnet_tpu/models/mmvit2.py:195-198``).

Three forms of one function, with the same parameters, as in the JAX module:

  * ``fuse_depth=True`` (the default): every depth resize is contracted into
    the 3^3 conv that follows it (``nn/depthfuse.py``). ``up2_conv``
    resizes H and W at the coarse depth, in the compute dtype, and convolves
    at half the depth; ``skip_concat_conv`` resizes the skip in H and W only
    and convolves its block at the skip's own rows (3 at every level for
    MMVit4; 3, 2, 1, 1 for MMVit2). The fine-depth input volumes are never
    built.
  * ``lean`` (with ``fuse_depth``; ``None`` = on at batch <= 4, the JAX
    module's rule): the 12 chain stages hand ``(y, a, b)`` to their
    consumer (``nn/leandec.py``), so their backward stores one volume per
    stage; they end in ``relu_in_stats`` instead of K3.
  * ``fuse_depth=False``: the plain resize-then-conv chain, kept as the
    oracle the fused forms are held to.

K3 ends the 15 RFM blocks always, and the 12 chain stages where lean is off.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn import Conv, FusionPrenorm, GeneralConv3d
from corrifnet_tpu_torch.nn import resize_linear, resize_nearest
from corrifnet_tpu_torch.nn.leandec import LeanGeneralConv3d, lean_head

__all__ = ["DecoderFuse"]

BD = 8  # basic_dims (mmvit4.py:10)


def _chain_conv(cin, cout, k):
    return GeneralConv3d(cin, cout, k, 1, 1 if k == 3 else 0,
                         padding_mode="replicate")


class DecoderFuse(nn.Module):
    """Takes the skips x1..x4 ((B, 24/48/96/192, D, H, W), any depth D and
    size: MMVit4's early-fused skips are at D = 3 and H = W = 56/56/28/14,
    MMVit2's stacked ones at D = 3/2/1/1 and H = W = 224/112/56/28) and the
    bottleneck x5 ((B, 192, 8, 8, 8)); returns sigmoid probabilities (B, 3,
    1, 224, 224). ``lean`` is fixed when the module is built (None: by the
    batch of each call); ``use_reduce`` puts ``RFM5_reduce`` after ``RFM5``."""

    def __init__(self, fuse_depth: bool = True, lean: "bool | None" = None,
                 use_reduce: bool = True):
        super().__init__()
        self.fuse_depth = fuse_depth
        self.lean = lean
        self.RFM5 = FusionPrenorm(BD * 8 * 3)
        self.RFM5_reduce = Conv(BD * 8 * 3, BD * 16, 1) if use_reduce else None
        self.RFM4 = FusionPrenorm(BD * 8 * 3)
        self.RFM3 = FusionPrenorm(BD * 4 * 3)
        self.RFM2 = FusionPrenorm(BD * 2 * 3)
        self.RFM1 = FusionPrenorm(BD * 3)
        chain = {"d4_c1": (BD * 16 if use_reduce else BD * 8 * 3, BD * 16, 3),
                 "d4_c2": (BD * 8 * 3 + BD * 16, BD * 8, 3),
                 "d4_out": (BD * 8, BD * 8, 1), "d3_c1": (BD * 8, BD * 4, 3),
                 "d3_c2": (BD * 4 * 3 + BD * 4, BD * 4, 3), "d3_out": (BD * 4, BD * 4, 1),
                 "d2_c1": (BD * 4, BD * 2, 3), "d2_c2": (BD * 2 * 3 + BD * 2, BD * 2, 3),
                 "d2_out": (BD * 2, BD * 2, 1), "d1_c1": (BD * 2, BD, 3),
                 "d1_c2": (BD * 3 + BD, BD, 3), "d1_out": (BD, BD, 1)}
        for name, (cin, cout, k) in chain.items():
            setattr(self, name, _chain_conv(cin, cout, k))
        self.final_conv = Conv(BD, 3, 1)
        # the lean twins of the chain stages, on the same parameters (a
        # plain dict: the state_dict is the standard chain's)
        self._lean = {}
        if fuse_depth and lean is not False:
            coarse = {"d4_c1": 8, "d3_c1": 16, "d2_c1": 32, "d1_c1": 64}
            for name in chain:
                s = coarse.get(name)
                self._lean[name] = LeanGeneralConv3d.sharing(
                    getattr(self, name), (s, 2 * s, 2 * s) if s else ())

    def _uses_lean(self, batch):
        if not self.fuse_depth:
            return False
        return self.lean if self.lean is not None else batch <= 4

    def _bottleneck(self, x5):
        run = self.RFM5(x5)
        return run if self.RFM5_reduce is None else self.RFM5_reduce(run)

    def forward(self, x1, x2, x3, x4, x5):
        if self._uses_lean(x1.shape[0]):
            return self._lean_cascade(x1, x2, x3, x4, x5)
        fuse = self.fuse_depth
        run = self._bottleneck(x5)
        levels = (
            (x4, self.RFM4, self.d4_c2, self.d4_out, self.d3_c1, 16),
            (x3, self.RFM3, self.d3_c2, self.d3_out, self.d2_c1, 32),
            (x2, self.RFM2, self.d2_c2, self.d2_out, self.d1_c1, 64),
            (x1, self.RFM1, self.d1_c2, self.d1_out, None, 128),
        )
        c1, src = self.d4_c1, 8
        for skip, rfm, c2, out, next_c1, size in levels:
            # up2_conv: trilinear x2 then the 3^3 conv
            if fuse:
                run = resize_linear(run, (src, size, size), compute_dtype=run.dtype)
                run = c1(run, ("linear", size))
            else:
                run = c1(resize_linear(run, (size,) * 3))
            # skip_concat_conv: nearest resize of the skip, concat, 3^3 conv
            skip = rfm(skip)
            if fuse:
                skip = resize_nearest(skip, (skip.shape[2], size, size))
                run = c2((skip, run), ("nearest", size))
            else:
                run = c2(torch.cat([resize_nearest(skip, (size,) * 3), run], dim=1))
            run = out(run)
            c1, src = next_c1, size
        head = resize_linear(run[:, :, :1], (1, 224, 224))
        return torch.sigmoid(self.final_conv(head).float())

    def _lean_cascade(self, x1, x2, x3, x4, x5):
        """The fused cascade with lean stages (JAX ``_lean_cascade``): each
        chain stage hands ``(y, a, b)`` to the next."""
        lean = self._lean
        h = lean["d4_c1"](self._bottleneck(x5), ("linear", 16))
        levels = ((x4, self.RFM4, "d4", "d3", 16), (x3, self.RFM3, "d3", "d2", 32),
                  (x2, self.RFM2, "d2", "d1", 64), (x1, self.RFM1, "d1", None, 128))
        for skip, rfm, this, nxt, size in levels:
            sk = rfm(skip)
            sk = resize_nearest(sk, (sk.shape[2], size, size))
            h = lean[this + "_c2"]((sk, h), ("nearest", size))
            h = lean[this + "_out"](h)
            if nxt is not None:
                h = lean[nxt + "_c1"](h, ("linear", size * 2))
        head = resize_linear(lean_head(h), (1, 224, 224))
        return torch.sigmoid(self.final_conv(head).float())
