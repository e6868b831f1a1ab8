"""The port's FASSDNet against the JAX package, on the CPU in f32.

FASSDNet is on the 4-D input path: one modality, (B, 3, H, W) with H and W
multiples of 32; output (B, 1, H, W). The model checks are
``tests/torch_zoo_model.py``'s:

* primitives: ``avg_pool`` (f32 sums, with and without the padded zeros in
  the divisor), the HarDBlock link topology and widths (the port's copy of
  ``hard_block_link``), HarDBlock, DAPF (dilations 12/24/36 on a 7x7 map)
  and MDA (dilated per axis) in train mode, against the JAX modules;
* the whole forward at B=1 in eval mode, 64x64 and 224x224, the BatchNorms
  calibrated (at identity statistics the output is flat);
* one training step at B=2 and at B=1, 64x64 (FASSDNet has no dropout and
  no gradient that a BatchNorm makes 0);
* the ``state_dict`` both ways, bit for bit, 2,844,469 parameters; ``notr``
  re-initializes the JAX package's 75 kernels; MDA's dilations going up are
  8, 4, 2, as the code has them.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import fassdnet as jf
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu.nn.resize import avg_pool as jax_avg_pool
from corrifnet_tpu_torch.models import create_model, fassdnet_state_dict_from_variables
from corrifnet_tpu_torch.models import fassdnet as pf
from corrifnet_tpu_torch.nn import avg_pool
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_model import (
    F32,
    Zoo,
    check_notr,
    check_round_trip,
    check_train_step,
    check_whole_model,
    nchw,
    nhwc,
)
from torch_zoo_step import SCHEMES

FASSDNET = Zoo("FASSDNet", lambda dt: jf.FASSDNet(dtype=dt),
               ti.fassdnet_variables_from_state_dict, fassdnet_state_dict_from_variables)
FASSDNET_PARAMS = 2_844_469  # the JAX init tree's (jax.eval_shape)
NOTR_KERNELS = 75  # the JAX tree's 4-axis kernels


def _reset(module, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters(gen)
    return module


def _train_mode_matches_jax(block, jax_block, convert, x, atol=1e-5):
    """``block`` in train mode against ``jax_block`` with the parameters
    ``convert`` reads from its state_dict: the output, and the running
    statistics after it."""
    sd = {f"b.{k}": v.clone() for k, v in block.state_dict().items()}
    params, stats = convert(sd)
    with torch.no_grad():
        got = block.train()(x).numpy()
    want, new = jax_block.apply({"params": params, "batch_stats": stats}, nhwc(x), True,
                                mutable=["batch_stats"])
    np.testing.assert_allclose(got, nchw(want), rtol=0, atol=atol * np.abs(want).max())
    back = convert({f"b.{k}": v for k, v in block.state_dict().items()})[1]
    for path, leaf in jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, leaf, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ primitives


@pytest.mark.parametrize("window,strides,padding,include", [
    ((2, 2), (2, 2), (0, 0), True), ((3, 3), (2, 2), (1, 1), True),
    ((3, 3), (2, 2), (1, 1), False)])
def test_avg_pool_matches_jax(window, strides, padding, include):
    """The 2x2 transition pool, and a padded 3x3 one with the padded zeros
    in the divisor and without, on an odd-sized bf16 map (summed in f32,
    returned in bf16), against the JAX ``avg_pool``."""
    x = torch.randn((2, 5, 9, 7), generator=torch.Generator().manual_seed(1))
    for dt in (torch.float32, torch.bfloat16):
        got = avg_pool(x.to(dt), window, strides, padding, count_include_pad=include)
        want = nchw(jax_avg_pool(nhwc(x.to(dt).float()).astype(
            {torch.float32: np.float32, torch.bfloat16: jax.numpy.bfloat16}[dt]),
            window, strides, padding, count_include_pad=include).astype(np.float32))
        assert got.dtype == dt
        # f32: the same sums; bf16: the f32 means rounded, within one ulp
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                                   rtol=1e-6 if dt == torch.float32 else 2 ** -7)


def test_hard_block_topology_is_jaxs():
    """The port's copy of ``hard_block_link`` and ``hard_block_out_ch`` give
    the JAX package's links and widths at every block of the model."""
    for base in (48, 64, 96, 160, 224, 200, 150):
        for gr, n in zip(pf.GROWTH, pf.N_LAYERS):
            for layer in range(n + 1):
                assert pf.hard_block_link(layer, base, gr, pf.GRMUL) == jf.hard_block_link(
                    layer, base, gr, pf.GRMUL)
            assert pf.hard_block_out_ch(base, gr, pf.GRMUL, n) == jf.hard_block_out_ch(
                base, gr, pf.GRMUL, n)
    block = pf.HarDBlock(48, 10, pf.GRMUL, 4)
    assert block.links == [[0], [1, 0], [2], [3, 2, 0]]


@pytest.mark.parametrize("cin,gr,n", [(48, 10, 4), (96, 18, 8)])
def test_hardblock_matches_jax_in_train_mode(cin, gr, n):
    block = _reset(pf.HarDBlock(cin, gr, pf.GRMUL, n), gr)
    x = torch.randn((2, cin, 8, 8), generator=torch.Generator().manual_seed(gr))
    _train_mode_matches_jax(block, jf.HarDBlock(cin, gr, pf.GRMUL, n, dtype=F32),
                            lambda sd: ti._fassd_hardblock(sd, "b", n), x)


def test_dapf_matches_jax_in_train_mode():
    """DAPF at the model's 320 channels on its 7x7 map (at rates 12, 24 and
    36 the dilated taps fall on padding but the centre's)."""
    block = _reset(pf.DAPF(320, 2), 3)
    x = torch.randn((2, 320, 7, 7), generator=torch.Generator().manual_seed(3))
    _train_mode_matches_jax(block, jf.DAPF(320, 2, dtype=F32),
                            lambda sd: ti._fassd_dapf(sd, "b"), x)


@pytest.mark.parametrize("d", [2, 8])
def test_mda_matches_jax_in_train_mode(d):
    """MDA with the asymmetric (3,1)/(1,3) branch dilated (d, 1) and (1, d)."""
    block = _reset(pf.MDA(40, d), d)
    x = torch.randn((2, 40, 12, 10), generator=torch.Generator().manual_seed(d))
    _train_mode_matches_jax(block, jf.MDA(40, d, dtype=F32),
                            lambda sd: ti._fassd_mda(sd, "b"), x)


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("hw", [64, 224])
def test_whole_model_matches_jax(hw):
    """B=1, f32, eval mode, BatchNorms calibrated: the probabilities within
    5e-5, or twice the port's own change under a 1e-6 change of the input.
    Measured: 2.4e-7 at 64x64."""
    check_whole_model(FASSDNET, hw)


@pytest.mark.parametrize("b", [2, 1])
def test_train_step_matches_jax(b, monkeypatch):
    """One training-mode step at 64x64, f32, BatchNorm on batch statistics:
    the loss within 1e-5 and the gradients to ``hold_step``'s bounds; no
    dropout site and no gradient that is 0 but for rounding."""
    assert check_train_step(FASSDNET, monkeypatch, seed=5, b=b) == []


def test_state_dict_round_trip_is_exact():
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit, under the
    reference's keys (``base`` with its pools' indices left free)."""
    sd = check_round_trip(FASSDNET, FASSDNET_PARAMS)
    for key in ("base.0.conv.weight", "base.4.layers.3.norm.running_mean",
                "base.14.conv.weight", "DAPF.pyBranch4.atrous_conv1x3.weight",
                "conv1x1_up.2.norm.bias", "mda.0.parallel_ddconv3x1.bn_prelu.acti.weight",
                "mda.2.conv1x1.conv.weight", "denseBlocksUp.2.layers.3.conv.weight",
                "finalConv.bias"):
        assert key in sd, key
    assert not any(k.startswith(("base.6.", "base.9.", "base.12.")) for k in sd)


def test_mda_dilations_follow_the_code():
    """Going up, MDA takes the dilation list at the block indices 2, 1, 0:
    8, 4 and 2 (the JAX module's docstring says 16/8/4)."""
    model = create_model("FASSDNet")
    for mda, d in zip(model.mda, (8, 4, 2)):
        assert mda.parallel_ddconv3x1.conv.dilation == (d, 1)
        assert mda.parallel_ddconv1x3.conv.dilation == (1, d)
        assert mda.parallel_ddconv3x1.conv.padding == (d, 0)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_notr_reinitializes_what_jax_does(scheme):
    """The 75 kernels of the JAX tree (every conv), the final conv's bias
    zeroed, the BatchNorms and PReLU slopes as built."""
    names = check_notr(FASSDNET, scheme, NOTR_KERNELS)
    assert "finalConv.weight" in names
