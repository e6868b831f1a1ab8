"""A small 5-D stand-in model for the port's run-level tests.

``TinySeg5D`` is the port's twin of the JAX stand-ins of
``tests/test_resume.py`` (``TinySeg5D``, f32) and ``tests/test_train_loop.py``
(``TinySegBf16``): the three modalities' bands as nine channels, a 3x3 conv
to ``width`` channels, ReLU, a 1x1 conv to three, sigmoid, as (B, 3, 1, H, W).
``registered`` puts it in the port's model registry under the names
``TinySeg5D`` (width 4) and ``TinySegBf16`` (width 8) for one test.
``jax_params`` / ``port_state_dict`` convert its weights between the two
packages' layouts.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.models import registry


class TinySeg5D(nn.Module):
    def __init__(self, dtype=torch.float32, width=4, **_options):
        super().__init__()
        self.compute_dtype = dtype
        self.conv0 = nn.Conv2d(9, width, 3, padding=1)
        self.conv1 = nn.Conv2d(width, 3, 1)

    def reset_parameters(self, generator):
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=generator) * 0.3)
        return self

    def set_dropout_rng(self, rng):
        return self

    def forward(self, x):
        b, m, c, h, w = x.shape
        dt = self.compute_dtype
        y = x.to(dt).reshape(b, m * c, h, w)
        y = F.relu(F.conv2d(y, self.conv0.weight.to(dt), self.conv0.bias.to(dt), padding=1))
        y = F.conv2d(y, self.conv1.weight.to(dt), self.conv1.bias.to(dt))
        return torch.sigmoid(y.float())[:, :, None]


@pytest.fixture
def registered():
    for name, width in (("TinySeg5D", 4), ("TinySegBf16", 8)):
        registry._REGISTRY[name] = registry.ModelSpec(
            name, functools.partial(TinySeg5D, width=width), "5d")
    yield
    for name in ("TinySeg5D", "TinySegBf16"):
        registry._REGISTRY.pop(name, None)


def jax_params(state_dict):
    """The flax ``params`` of the JAX stand-in from the port's state_dict."""
    def conv(key):
        w = state_dict[f"{key}.weight"].numpy()
        return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                "bias": state_dict[f"{key}.bias"].numpy().copy()}

    return {"Conv_0": conv("conv0"), "Conv_1": conv("conv1")}


def port_state_dict(params):
    """The port's state_dict from the JAX stand-in's flax ``params``."""
    sd = {}
    for key, name in (("conv0", "Conv_0"), ("conv1", "Conv_1")):
        sd[f"{key}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(params[name]["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"{key}.bias"] = torch.from_numpy(np.asarray(params[name]["bias"]).copy())
    return sd
