"""MMVit4's ``remat_mode`` in the port: the encoders' tail blocks
rematerialized in the backward, as the JAX package's ``_BottleneckTail``
and ``PackedStage1`` rematerialize them.

Remat changes no bit. One training step of a full-width
``ResNet3DEncoder`` (B=2, 32x32, f32) under each mode, with the standard
bottleneck, the fused one (``pallas_fused``: the CPU plain versions of
K4a-K4d) and ``fuse_expand_bn``, gives the loss, every gradient and every
running statistic of the same step under ``"none"``, compared with
``torch.equal``. Each BatchNorm updates its running statistics once in the
step, whatever the mode, and the recompute runs where the mode says:
``tail_remat`` is the JAX package's choice of blocks, and the mode reaches
every encoder of a model built by the registry and by ``run.main``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from corrifnet_tpu_torch.models import create_model, resnet3d
from corrifnet_tpu_torch.models.resnet3d import (
    LAYERS,
    REMAT_MODES,
    ResNet3DEncoder,
    tail_remat,
)
from corrifnet_tpu_torch.nn import norm
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

VARIANTS = {"standard": {}, "pallas_fused": {"pallas_fused": True},
            "fuse_expand_bn": {"fuse_expand_bn": True}}
# JAX: PackedStage1 rematerializes layer 1 unless "none" ("mid" for "mid1"),
# _BottleneckTail layers 2-4 for "all" and "mid", and "early" at width <= 128
JAX_CHOICE = {
    "none": (None, None, None, None),
    "all": ("all", "all", "all", "all"),
    "early": ("all", "all", None, None),
    "mid": ("mid", "mid", "mid", "mid"),
    "mid1": ("mid", "all", "all", "all"),
}


def _encoder(mode, variant):
    enc = ResNet3DEncoder(remat_mode=mode, **VARIANTS[variant])
    gen = torch.Generator().manual_seed(5)
    for module in enc.modules():
        if module is not enc and hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    return enc.train()


def _step(mode, variant, monkeypatch):
    """(loss, {name: gradient}, {name: buffer}, running updates, forward
    calls of the blocks' parts) of one training step."""
    enc = _encoder(mode, variant)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 1, 3, 32, 32)).astype(np.float32))
    updates, calls = [], []
    real_update = norm.bn_update_running
    monkeypatch.setattr(norm, "bn_update_running",
                        lambda *a: updates.append(a[0].shape[0]) or real_update(*a))
    for name in ("_reduce", "_fused_reduce", "_expand", "_fused_expand"):
        real = getattr(resnet3d.Bottleneck3D, name)
        monkeypatch.setattr(resnet3d.Bottleneck3D, name,
                            lambda self, *a, _r=real, _n=name: calls.append(_n) or _r(self, *a))
    outs = enc(x)
    cots = [torch.from_numpy(rng.normal(0, 1, o.shape).astype(np.float32)) for o in outs]
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in enc.named_parameters()}
    buffers = {n: b.clone() for n, b in enc.named_buffers()}
    return loss.detach(), grads, buffers, updates, calls, enc


@pytest.fixture(scope="module")
def baseline():
    steps = {}
    for v in VARIANTS:
        with pytest.MonkeyPatch.context() as patch:
            steps[v] = _step("none", v, patch)
    return steps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", [m for m in REMAT_MODES if m != "none"])
def test_every_mode_gives_the_bits_of_none(mode, variant, baseline, monkeypatch):
    loss0, grads0, buffers0, updates0, calls0, enc = baseline[variant]
    loss, grads, buffers, updates, calls, _ = _step(mode, variant, monkeypatch)
    assert torch.equal(loss, loss0)
    assert sorted(grads) == sorted(grads0) == sorted(n for n, _ in enc.named_parameters())
    for n in grads0:
        assert torch.equal(grads[n], grads0[n]), n
    assert sorted(buffers) == sorted(buffers0)
    for n in buffers0:
        assert torch.equal(buffers[n], buffers0[n]), n
    # one running update per BatchNorm in the step, in both
    n_bn = sum(isinstance(m, norm.BatchNorm) for m in enc.modules())
    assert len(updates0) == len(updates) == n_bn
    # the parts that run again: conv1's in "all" alone, conv3's in both
    tails = [(li, tail_remat(mode, li)) for li, (blocks, _) in enumerate(LAYERS)
             for _ in range(blocks - 1)]
    reduce_name = "_fused_reduce" if variant == "pallas_fused" else "_reduce"
    expand_name = "_fused_expand" if variant == "pallas_fused" else "_expand"
    again_reduce = sum(r == "all" or (r == "mid" and variant != "pallas_fused")
                       for _, r in tails)
    again_expand = sum(r is not None for _, r in tails)
    assert calls.count(reduce_name) == calls0.count(reduce_name) + again_reduce
    assert calls.count(expand_name) == calls0.count(expand_name) + again_expand


def test_running_statistics_take_one_update(baseline):
    """After the step, every running mean is 0.1 of the batch mean and
    every running variance 0.9 + 0.1 of the unbiased batch variance: one
    update from the initial (0, 1). The stem's statistics, recomputed here
    from its output, are the check's witness of the formula."""
    _, _, buffers, _, _, enc = baseline["standard"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 1, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        y = torch.relu(enc.e1_c1(x)).double()
    mean = y.mean(dim=(0, 2, 3, 4))
    var = y.var(dim=(0, 2, 3, 4), unbiased=True)
    np.testing.assert_allclose(buffers["e1_bn.running_mean"].double(), 0.1 * mean,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(buffers["e1_bn.running_var"].double(), 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", REMAT_MODES)
def test_tail_remat_is_the_jax_choice(mode):
    assert tuple(tail_remat(mode, li) for li in range(4)) == JAX_CHOICE[mode]


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="remat_mode 'some'"):
        tail_remat("some", 0)


def _modes(model):
    """{encoder layer: the remat of its blocks, block 0 first}."""
    return {f"{m}.e{li + 2}": [b.remat for b in getattr(getattr(model, f"{m}_encoder"),
                                                         f"e{li + 2}")]
            for m in ("RGB", "NIR", "SWIR") for li in range(4)}


def test_the_mode_reaches_every_encoder_of_the_registry_model():
    model = create_model("MMVit4", remat_mode="mid1")
    for key, remats in _modes(model).items():
        li = int(key[-1]) - 2
        assert remats == [None] + [JAX_CHOICE["mid1"][li]] * (LAYERS[li][0] - 1), key
    default = create_model("MMVit4")
    assert all(r[1:] == ["all"] * (len(r) - 1) and r[0] is None
               for r in _modes(default).values())
    default.set_remat_mode("early")
    for key, remats in _modes(default).items():
        li = int(key[-1]) - 2
        assert remats == [None] + [JAX_CHOICE["early"][li]] * (LAYERS[li][0] - 1), key


def test_training_entry_point_passes_the_mode(tmp_path, monkeypatch, capsys):
    """``run.main`` gives ``remat_mode`` to the model, as the JAX package's
    ``_build_model`` gives it to MMVit4 alone; ``check_supported`` no
    longer names it. The run stops at the build."""
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import main

    class Built(Exception):
        pass

    def create(name, **kwargs):
        raise Built(name, kwargs)

    monkeypatch.setattr(main, "create_model", create)
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "remat_mode": "early"}))
    with pytest.raises(Built) as built:
        main.main(["--config", "cfg.json", "--run-root", ".", "--device", "cpu"])
    name, kwargs = built.value.args
    assert name == "MMVit4" and kwargs["remat_mode"] == "early"
    assert "remat_mode" not in capsys.readouterr().out


def test_evaluation_entry_point_builds_without_the_mode(tmp_path, monkeypatch, capsys):
    """``run.evaluate`` builds the model without ``remat_mode``, as the JAX
    package's ``evaluate_run`` does (remat acts in training alone), and
    names it on one line."""
    from torch_levers import check_entry_points_take

    check_entry_points_take("MMVit4", "remat_mode", "mid", tmp_path, monkeypatch, capsys,
                            entries=("evaluate",))


def test_other_models_name_the_mode_as_inert(capsys):
    """A model that does not take it names it on one line (the JAX
    package's ``_build_model`` gives it to MMVit4 alone)."""
    create_model("UNetV2", remat_mode="none")
    assert "remat_mode='none' have no effect on UNetV2" in capsys.readouterr().out
