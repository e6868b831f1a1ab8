"""The port's 2-D -> 3-D ResNet50 inflation against the JAX package's.

torchvision is not needed: a seeded ``state_dict`` with ResNet50's exact
tensor names and shapes (and its BatchNorm and ``fc`` tensors, which
inflation does not read) stands in, its conv weights at He scale so that
a forward stays O(1). JAX's ``inflate_resnet50`` -> ``merge_params`` over a
fresh JAX ``ResNet3DEncoder`` tree (the per-modality, unpacked form),
converted by the port's encoder converter (``models/jax_import.py``), is
the port's ``merge_params`` of its ``inflate_resnet50`` over the same
fresh tree, bit for bit; the merged encoders' eval-mode forwards at B=1,
32x32, f32 agree to 2e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import inflate as jax_inflate
from corrifnet_tpu.models.resnet3d import ResNet3DEncoder as JaxEncoder
from corrifnet_tpu_torch.models import inflate
from corrifnet_tpu_torch.models.jax_import import _encoder
from corrifnet_tpu_torch.models.resnet3d import ResNet3DEncoder
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

ATOL = 2e-5
# torchvision resnet50: layer -> (blocks, width, out channels, in channels)
_RESNET50 = {1: (3, 64, 256, 64), 2: (4, 128, 512, 256), 3: (6, 256, 1024, 512),
             4: (3, 512, 2048, 1024)}


def _resnet50_state_dict(seed=0):
    rng = np.random.default_rng(seed)

    def conv(o, i, k):
        return rng.normal(0, np.sqrt(1.0 / (i * k * k)), (o, i, k, k)).astype(np.float32)

    def bn(sd, key, c):
        for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
            sd[f"{key}.{name}"] = np.full(c, value, np.float32)

    sd = {"conv1.weight": conv(64, 3, 7)}
    bn(sd, "bn1", 64)
    for li, (blocks, width, out_ch, in_ch) in _RESNET50.items():
        for bi in range(blocks):
            cin = in_ch if bi == 0 else out_ch
            key = f"layer{li}.{bi}"
            sd[f"{key}.conv1.weight"] = conv(width, cin, 1)
            sd[f"{key}.conv2.weight"] = conv(width, width, 3)
            sd[f"{key}.conv3.weight"] = conv(out_ch, width, 1)
            for j, c in ((1, width), (2, width), (3, out_ch)):
                bn(sd, f"{key}.bn{j}", c)
        sd[f"layer{li}.0.downsample.0.weight"] = conv(out_ch, in_ch, 1)
        bn(sd, f"layer{li}.0.downsample.1", out_ch)
    sd["fc.weight"] = rng.normal(0, 0.01, (1000, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def _port_state(params, stats):
    sd = {}
    _encoder(sd, "enc", jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    return {k[len("enc."):]: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def merged():
    """(JAX encoder, JAX merged variables, port merged encoder, the
    state_dict's torch form)."""
    sd = _resnet50_state_dict()
    jenc = JaxEncoder()
    x = jnp.zeros((1, 3, 32, 32, 1), jnp.float32)
    fresh = jax.jit(lambda key: jenc.init({"params": key}, x, False))(jax.random.PRNGKey(0))
    params = jax_inflate.merge_params(jax.tree.map(np.asarray, fresh["params"]),
                                      jax_inflate.inflate_resnet50(sd))
    variables = {"params": params, "batch_stats": fresh["batch_stats"]}

    enc = ResNet3DEncoder()
    enc.load_state_dict(_port_state(fresh["params"], fresh["batch_stats"]), strict=True)
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    inflate.merge_params(enc, inflate.inflate_resnet50(torch_sd))
    return jenc, variables, enc.eval(), sd


def test_inflated_kernels_follow_the_rules():
    sd = _resnet50_state_dict(1)
    got = inflate.inflate_resnet50(sd)
    assert got["e1_c1.weight"].shape == (64, 1, 3, 7, 7)
    mean = torch.from_numpy(sd["conv1.weight"].mean(axis=1))
    for t in range(3):
        assert torch.equal(got["e1_c1.weight"][:, 0, t], mean)
    w = got["e3.2.conv2.weight"]
    assert w.shape == (128, 128, 1, 3, 3)
    assert torch.equal(w[:, :, 0], torch.from_numpy(sd["layer2.2.conv2.weight"]))
    assert got["e5.0.downsample.0.weight"].shape == (2048, 1024, 1, 1, 1)
    assert len(got) == 1 + sum(3 * b + 1 for b, *_ in _RESNET50.values())


def test_merged_encoder_equals_the_jax_merge_bit_for_bit(merged):
    _, variables, enc, _ = merged
    want = _port_state(variables["params"], variables["batch_stats"])
    got = enc.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_merge_leaves_batchnorms_and_adapt_convs_as_built(merged):
    _, _, enc, sd = merged
    built = ResNet3DEncoder()
    gen = torch.Generator().manual_seed(0)
    for module in built.modules():
        if module is not built and hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    before = {k: v.clone() for k, v in built.state_dict().items()}
    inflated = inflate.inflate_resnet50(sd)
    inflate.merge_params(built, inflated)
    for key, value in built.state_dict().items():
        assert torch.equal(value, inflated[key] if key in inflated else before[key]), key
    assert not any(".bn" in k or "adapt" in k or "downsample.1" in k for k in inflated)
    bad = {"e1_c1.weight": torch.zeros(64, 1, 1, 7, 7)}
    with pytest.raises(ValueError, match="e1_c1.weight"):
        inflate.merge_params(built, bad)


def test_merged_forward_matches_jax(merged):
    jenc, variables, enc, _ = merged
    x = np.random.default_rng(3).normal(0, 1, (1, 3, 32, 32)).astype(np.float32)
    want = jax.jit(lambda v, xx: jenc.apply(v, xx, False))(
        variables, jnp.asarray(x[..., None]))
    with torch.no_grad():
        got = enc(torch.from_numpy(x[:, None]))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        w = np.moveaxis(np.asarray(w), -1, 1)
        assert g.shape == w.shape and np.isfinite(w).all()
        err = np.abs(g.numpy() - w).max()
        print("inflated encoder level against JAX:", g.shape, err, np.abs(w).max())
        assert err <= ATOL, (g.shape, err)
