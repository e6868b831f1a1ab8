"""The port's MMVit4 and evaluation path against the JAX package.

* whole-model parity: the port at 64x64 input, B=2, f32, against the JAX
  ``MMVit4`` at its defaults (jitted) with the port's weights converted by
  ``corrifnet_tpu.models.torch_import``;
* weights: JAX variables -> ``mmvit4_state_dict_from_variables`` -> strict
  load -> ``mmvit4_variables_from_state_dict`` returns every leaf bit for
  bit, for the packed and the unpacked tree;
* every module of the port imports, and the evaluation entry point runs,
  with jax, jaxlib, flax, optax and the whole JAX package blocked;
* the evaluation entry point's plumbing on the CPU.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models.mmvit4 import MMVit4 as JaxMMVit4
from corrifnet_tpu.models.torch_import import mmvit4_variables_from_state_dict
from corrifnet_tpu_torch.models import create_model, mmvit4_state_dict_from_variables
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.testing import calibrate_batchnorm
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
# the JAX tree's parameter count (MMVit4().init at 64x64), batch_stats excluded
MMVIT4_PARAMS = 85_380_939
# NOTES zoo-parity bound for f32 whole-model forwards
MODEL_ATOL = 5e-5


@pytest.fixture(scope="module")
def port_model_and_input():
    """Port MMVit4 from seed 0 with random positional embeddings and
    BatchNorm statistics calibrated on the input (see calibrate_batchnorm:
    raw-init statistics let activations reach ~1e3, where the correlation
    softmax saturates and f32 rounding alone decides its outputs)."""
    model = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_pos"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    x = rng.normal(0, 1, (2, 3, 3, 64, 64)).astype(np.float32)
    calibrate_batchnorm(model, torch.from_numpy(x))
    return model, x


def test_create_model_is_seeded_and_full_size():
    a = create_model("MMVit4", seed=3).state_dict()
    b = create_model("MMVit4", seed=3).state_dict()
    c = create_model("MMVit4", seed=4).state_dict()
    key = "decoder_fuse.d1_c2.conv.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    model = create_model("MMVit4")
    assert sum(p.numel() for p in model.parameters()) == MMVIT4_PARAMS
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_create_model_rejects_unported_models():
    # every model the JAX package can build is ported; MMVit1's module is
    # absent from the reference's snapshot, so neither package builds it
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_model("MMVit1")


def test_whole_model_matches_jax(port_model_and_input):
    model, x = port_model_and_input
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    variables = mmvit4_variables_from_state_dict(model.state_dict(), pack_stage1=True)
    jm = JaxMMVit4(dtype=jnp.float32)
    fwd = jax.jit(lambda v, xx: jm.apply(v, xx, False))
    want = np.asarray(fwd(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        jnp.asarray(x),
    ))
    assert got.shape == want.shape == (2, 3, 1, 224, 224)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=0)


def _jax_layout_variables(pack_stage1, seed):
    """A JAX MMVit4 variable tree of the right structure (from
    jax.eval_shape of init), filled with seeded random numbers."""
    shapes = jax.eval_shape(
        lambda r, xx: JaxMMVit4(pack_stage1=pack_stage1).init({"params": r}, xx, False),
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 64, 64), jnp.float32),
    )
    rng = np.random.default_rng(seed)
    fill = lambda s: rng.normal(0, 1, s.shape).astype(np.float32)  # noqa: E731
    return {c: jax.tree.map(fill, shapes[c]) for c in ("params", "batch_stats")}


@pytest.mark.parametrize("pack_stage1", [True, False])
def test_state_dict_round_trip_is_exact(pack_stage1):
    variables = _jax_layout_variables(pack_stage1, seed=int(pack_stage1))
    model = create_model("MMVit4")
    model.load_state_dict(mmvit4_state_dict_from_variables(variables), strict=True)
    back = mmvit4_variables_from_state_dict(model.state_dict(), pack_stage1=pack_stage1)
    want = flatten_variables(variables)
    got = flatten_variables({c: back[c] for c in ("params", "batch_stats")})
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib.abc, json, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "corrifnet_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")

    sys.meta_path.insert(0, Block())
    import torch
    import corrifnet_tpu_torch
    for mod in ("config", "data", "data.crossval", "data.dataset", "data.dstl",
                "metrics", "metrics.jaccard", "metrics.losses", "models",
                "models.decoder", "models.deeplabv3p", "models.elanet", "models.enet",
                "models.extras", "models.fassdnet", "models.inflate", "models.jax_import",
                "models.mmformer", "models.mmvit2", "models.mmvit4",
                "models.multisenseseg", "models.registry", "models.resnet3d",
                "models.rfnet", "models.robustseg", "models.segformer",
                "models.unet", "nn", "nn.conv",
                "nn.depthfuse", "nn.fusedbn", "nn.init", "nn.leandec", "nn.norm", "nn.pad",
                "nn.resize", "nn.transformer", "ops", "ops.attention", "ops.build",
                "ops.correlation", "ops.fusedconv", "ops.instancenorm", "run",
                "run.evaluate", "run.import_checkpoint", "run.main", "run.profile",
                "run.segplot", "testing", "train",
                "train.checkpoint", "train.loop", "train.schedule",
                "train.state", "utils", "utils.determinism", "utils.logfiles",
                "utils.profiling"):
        importlib.import_module("corrifnet_tpu_torch." + mod)
    from corrifnet_tpu_torch.data import write_permutation
    from corrifnet_tpu_torch.run.evaluate import main
    write_permutation(10, ".", seed=0)
    with open("cfg.json", "w") as f:
        json.dump({"train_set_size": 10, "synthetic_seed": 0, "dtype": "float32"}, f)
    r = main(["--config", "cfg.json", "--device", "cpu"])
    assert r["n_images"] == 2 and 0.0 <= r["jaccard_mean"] <= 1.0
    with open("cfg4.json", "w") as f:  # a 4-D model
        json.dump({"train_set_size": 10, "synthetic_seed": 0, "dtype": "float32",
                   "modeltype": "UNetV2", "chindex": "2"}, f)
    r = main(["--config", "cfg4.json", "--device", "cpu"])
    assert r["n_images"] == 2 and 0.0 <= r["jaccard_mean"] <= 1.0
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("OK")
""")


def test_port_imports_without_jax(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", "import importlib\n" + _BLOCKED_IMPORT],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path)},
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr


def test_load_weights_from_jax_npz_and_pt(tmp_path):
    from corrifnet_tpu_torch.run.evaluate import load_weights

    variables = _jax_layout_variables(True, seed=5)
    np.savez(tmp_path / "w.npz", **flatten_variables(variables))
    from_npz = load_weights(tmp_path / "w.npz")
    torch.save(from_npz, tmp_path / "w.pt")
    from_pt = load_weights(tmp_path / "w.pt")
    assert sorted(from_npz) == sorted(from_pt) == sorted(create_model("MMVit4").state_dict())
    for key in from_npz:
        assert torch.equal(from_npz[key], from_pt[key]), key


def test_per_image_metrics_matches_jax_composition():
    """The evaluation loop (padding, valid mask, per-image channel-0
    metrics) against the JAX package's metric on the same probabilities."""
    from corrifnet_tpu.metrics import jaccard_f1_pair as jax_pair
    from corrifnet_tpu_torch.run.evaluate import per_image_metrics

    rng = np.random.default_rng(8)
    images = rng.normal(0, 1, (7, 3, 3, 8, 8)).astype(np.float32)
    masks = (rng.random((7, 3, 1, 8, 8)) > 0.5).astype(np.float32)
    masks[2] = 0.0  # an all-background image

    def model(x):  # probabilities that depend on each image
        return torch.sigmoid(x[:, :, :1])

    idx = np.array([5, 2, 0, 6, 3])
    jacks, f1s, seconds = per_image_metrics(model, images, masks, idx, 4, "cpu")
    assert len(jacks) == len(f1s) == 5 and len(seconds) == 2
    for n, i in enumerate(idx):
        p = 1 / (1 + np.exp(-images[i, 0, :1].astype(np.float64)))
        want_j, want_f = jax_pair(masks[i, 0].reshape(-1, 1),
                                  p.astype(np.float32).reshape(-1, 1))
        np.testing.assert_allclose(jacks[n], np.asarray(want_j)[0], rtol=1e-5)
        np.testing.assert_allclose(f1s[n], np.asarray(want_f)[0], rtol=1e-5)
