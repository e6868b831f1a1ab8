"""2-D -> 3-D ResNet50 weight inflation (reference: mmvit4.py:83-111
``inflate_conv`` and Encoder.__init__).

Counterpart of ``corrifnet_tpu/models/inflate.py``, in the port's layout.
The reference inflates torchvision's ImageNet ResNet50 into the 3-D
encoder: the stem conv becomes kernel (3, 7, 7) with the RGB input channels
averaged to 1 and repeated over the depth axis (mmvit4.py:100-102); every
bottleneck conv and projection gets ``time_dim=1`` (``w2d.unsqueeze(2) /
time_dim``, mmvit4.py:105); BatchNorms are built fresh (inflation copies
conv weights only, mmvit4.py:121,132). MMVit4's constructor then
re-initializes every Conv3d (mmvit4.py:437-439), so the committed run never
used these weights, and no entry point of either package reaches this
module: it is the capability of warm-starting an encoder from a local
ResNet50 ``state_dict``.

``inflate_resnet50(state_dict)`` takes a torchvision-layout ResNet50
``state_dict`` (tensors or numpy arrays) and returns ``{key: tensor}`` in
``ResNet3DEncoder``'s key layout, kernels ``(O, I, Kd, Kh, Kw)``;
``merge_params(encoder, inflated)`` copies them into a built encoder.
The arithmetic is the JAX package's, in numpy float32, so the same
``state_dict`` gives the same bits in both.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from corrifnet_tpu_torch.models.resnet3d import LAYERS

__all__ = ["inflate_resnet50", "merge_params"]


def _to_np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _inflate(w2d: np.ndarray, time_dim: int) -> torch.Tensor:
    """(O, I, Kh, Kw) -> (O, I', T, Kh, Kw), the JAX package's ``_inflate``
    before its transpose to channels-last."""
    o, i, kh, kw = w2d.shape
    if i == 3 and time_dim > 1:
        # stem: average RGB to one input channel, repeat over depth
        w = w2d.mean(axis=1, keepdims=True)
        w3d = np.repeat(w[:, :, None], time_dim, axis=2)
    else:
        w3d = np.repeat(w2d[:, :, None], time_dim, axis=2) / time_dim
    return torch.from_numpy(np.ascontiguousarray(w3d, dtype=np.float32))


def inflate_resnet50(state_dict: Mapping[str, "np.ndarray"]) -> Dict[str, torch.Tensor]:
    """{ResNet3DEncoder key: inflated kernel} of every conv of the stem and
    the four layers. Keys of the input that are not conv weights (its
    BatchNorms, ``fc``) are not read."""
    sd = {k: _to_np(v) for k, v in state_dict.items() if k.endswith("weight")}
    out = {"e1_c1.weight": _inflate(sd["conv1.weight"], 3)}
    for li, (blocks, _) in enumerate(LAYERS, start=1):
        for bi in range(blocks):
            for ci in (1, 2, 3):
                out[f"e{li + 1}.{bi}.conv{ci}.weight"] = _inflate(
                    sd[f"layer{li}.{bi}.conv{ci}.weight"], 1)
        out[f"e{li + 1}.0.downsample.0.weight"] = _inflate(
            sd[f"layer{li}.0.downsample.0.weight"], 1)
    return out


def merge_params(encoder: torch.nn.Module, inflated: Mapping[str, torch.Tensor]):
    """Copy the inflated kernels into ``encoder`` (a ``ResNet3DEncoder``) in
    place, each shape checked; its BatchNorms, adapt convs and ``conv6``
    keep what they were built with (the reference's fresh BatchNorm3d).
    Returns the encoder."""
    params = dict(encoder.named_parameters())
    with torch.no_grad():
        for key, value in inflated.items():
            if key not in params:
                raise KeyError(f"{key}: not a parameter of the encoder")
            if params[key].shape != value.shape:
                raise ValueError(f"{key}: inflated {tuple(value.shape)}, encoder "
                                 f"{tuple(params[key].shape)}")
            params[key].copy_(value)
    return encoder
