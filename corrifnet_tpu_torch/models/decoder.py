"""Decoder_fuse, the multiscale decoder (reference mmvit4.py:222-292).

Counterpart of ``DecoderFuse`` in ``corrifnet_tpu/models/decoder.py``. At
each level an RFM block refines the early-fused
skip; the running state is up-sampled x2 (trilinear, align_corners=True)
into a replicate-padded 3^3 conv; the skip is resized to the running grid
with nearest interpolation, concatenated and convolved, then a 1^3 conv.
Depth grows 8 -> 16 -> 32 -> 64 -> 128. The head keeps depth slice 0 only
(``up_to_224`` with align_corners=True and output depth 1 samples source
depth 0, mmvit4.py:263).

``use_reduce`` (MMVit4's ``RFM5_reduce``, a 1x1 conv 192 -> 128 after
``RFM5``) is off for MMVit2 and mmformer, whose ``d4_c1`` takes the 192
channels of ``RFM5`` directly (``corrifnet_tpu/models/mmvit2.py:195-198``).

At ``depth_mode='full'`` (the reference's function) there are three forms
of one function, with the same parameters, as in the JAX module:

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

``depth_mode='pruned'`` (the JAX package's opt-in fast inference mode,
``decoder.py:105-216``) computes only the leading depth rows that reach the
head's depth slice 0: each up2 keeps 5 rows of the doubled depth (4 at level
1, ``resize_linear_depth_prefix``), each skip 4 rows (3 at level 1,
``resize_nearest_depth_prefix``), and the 3^3 convs pad depth at the top
edge only, so each drops one row. Resizes and convs are exact under the
cut; the InstanceNorm statistics are taken over the prefix, not over the
whole (mostly replicated) depth: a different function from the reference's
(PARITY.md), which JAX keeps for inference. The pruned chain is never
depth-fused and never lean.

Two memory levers, as in the JAX module:

  * ``remat_convs`` (``decoder_remat``): every chain ``GeneralConv3d`` of a
    non-lean cascade (fused, plain or pruned) runs under
    ``torch.utils.checkpoint``: its internals are recomputed in the
    backward (K3 runs again) instead of stored. Same bits forward and
    backward. The lean cascade ignores it, as JAX's does.
  * ``c2_chunks`` (``decoder_chunk``): in the lean cascade, ``d2_c2`` runs
    in ``c2_chunks // 2`` depth chunks, ``d1_c2`` and ``d1_out`` in
    ``c2_chunks`` (``nn/leandec.py``'s ``depth_chunks``); 0 is off.

K3 ends the 15 RFM blocks always, and the 12 chain stages where lean is off
(all 12 when pruned).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from corrifnet_tpu_torch.nn import Conv, FusionPrenorm, GeneralConv3d
from corrifnet_tpu_torch.nn import resize_linear, resize_nearest
from corrifnet_tpu_torch.nn.leandec import LeanGeneralConv3d, lean_head
from corrifnet_tpu_torch.nn.resize import (
    resize_linear_depth_prefix,
    resize_nearest_depth_prefix,
)

__all__ = ["DecoderFuse"]

BD = 8  # basic_dims (mmvit4.py:10)
DEPTH_MODES = ("full", "pruned")
# pruned: the depth rows each level keeps (up2, skip), decoder.py:154-203
_PREFIX = {16: (5, 4), 32: (5, 4), 64: (5, 4), 128: (4, 3)}


def _chain_conv(cin, cout, k, pruned):
    if k == 1:
        padding = 0
    else:
        # pruned: depth padded at the top edge only (decoder.py:121-124)
        padding = ((1, 0), (1, 1), (1, 1)) if pruned else 1
    return GeneralConv3d(cin, cout, k, 1, padding, padding_mode="replicate")


class DecoderFuse(nn.Module):
    """Takes the skips x1..x4 ((B, 24/48/96/192, D, H, W), any depth D and
    size: MMVit4's early-fused skips are at D = 3 and H = W = 56/56/28/14,
    MMVit2's stacked ones at D = 3/2/1/1 and H = W = 224/112/56/28) and the
    bottleneck x5 ((B, 192, 8, 8, 8)); returns sigmoid probabilities (B, 3,
    1, 224, 224). ``lean`` is fixed when the module is built (None: by the
    batch of each call); ``use_reduce`` puts ``RFM5_reduce`` after ``RFM5``;
    ``depth_mode``, ``remat_convs`` and ``c2_chunks`` as in the module
    docstring."""

    def __init__(self, fuse_depth: bool = True, lean: "bool | None" = None,
                 use_reduce: bool = True, depth_mode: str = "full",
                 remat_convs: bool = False, c2_chunks: int = 0):
        super().__init__()
        if depth_mode not in DEPTH_MODES:
            raise ValueError(f"depth_mode {depth_mode!r}, not one of {DEPTH_MODES}")
        self.pruned = depth_mode == "pruned"
        self.fuse_depth = fuse_depth and not self.pruned
        self.lean = lean
        self.remat_convs = remat_convs
        self.c2_chunks = c2_chunks
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
            setattr(self, name, _chain_conv(cin, cout, k, self.pruned))
        self.final_conv = Conv(BD, 3, 1)
        # the lean twins of the chain stages, on the same parameters (a
        # plain dict: the state_dict is the standard chain's)
        self._lean = {}
        if self.fuse_depth and lean is not False:
            coarse = {"d4_c1": 8, "d3_c1": 16, "d2_c1": 32, "d1_c1": 64}
            chunks = {"d2_c2": c2_chunks // 2, "d1_c2": c2_chunks, "d1_out": c2_chunks}
            for name in chain:
                s = coarse.get(name)
                self._lean[name] = LeanGeneralConv3d.sharing(
                    getattr(self, name), (s, 2 * s, 2 * s) if s else (),
                    chunks.get(name, 0))

    def _uses_lean(self, batch):
        if not self.fuse_depth:
            return False
        return self.lean if self.lean is not None else batch <= 4

    def _bottleneck(self, x5):
        run = self.RFM5(x5)
        return run if self.RFM5_reduce is None else self.RFM5_reduce(run)

    def _stage(self, conv, x, depth_fuse=None):
        """A chain ``GeneralConv3d``, rematerialized in the backward under
        ``remat_convs``."""
        if self.remat_convs and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(conv, x, depth_fuse,
                                                     use_reentrant=False)
        return conv(x, depth_fuse)

    def forward(self, x1, x2, x3, x4, x5):
        if self._uses_lean(x1.shape[0]):
            return self._lean_cascade(x1, x2, x3, x4, x5)
        fuse, pruned, stage = self.fuse_depth, self.pruned, self._stage
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
            if pruned:
                run = stage(c1, resize_linear_depth_prefix(
                    run, src, size, _PREFIX[size][0], (size, size)))
            elif fuse:
                run = resize_linear(run, (src, size, size), compute_dtype=run.dtype)
                run = stage(c1, run, ("linear", size))
            else:
                run = stage(c1, resize_linear(run, (size,) * 3))
            # skip_concat_conv: nearest resize of the skip, concat, 3^3 conv
            skip = rfm(skip)
            if pruned:
                skip = resize_nearest_depth_prefix(skip, size, _PREFIX[size][1], (size, size))
                run = stage(c2, torch.cat([skip, run], dim=1))
            elif fuse:
                skip = resize_nearest(skip, (skip.shape[2], size, size))
                run = stage(c2, (skip, run), ("nearest", size))
            else:
                run = stage(c2, torch.cat([resize_nearest(skip, (size,) * 3), run], dim=1))
            run = stage(out, run)
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
