"""The port's segplot (``corrifnet_tpu_torch/run/segplot.py``) against the
JAX package's (``corrifnet_tpu/run/segplot.py``): on the same seeded numpy
inputs both write the same file names with the same bytes, through
matplotlib and through the fallback PNG writer, and the colour math is the
same arrays."""

from __future__ import annotations

import importlib
import sys

import numpy as np
import pytest
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# by module path: corrifnet_tpu.run binds the name ``segplot`` to the function
jax_segplot = importlib.import_module("corrifnet_tpu.run.segplot")
torch_segplot = importlib.import_module("corrifnet_tpu_torch.run.segplot")


def _inputs(seed, lim=24):
    rng = np.random.default_rng(seed)
    image = rng.normal(0, 1, (lim, lim, 3)).astype(np.float32)
    pred = rng.random((lim, lim)).astype(np.float32)
    gt = (rng.random((lim, lim)) > 0.5).astype(np.float32)
    return lim, image, pred, gt, 0.5, 0.4, 0.3


_VARIANTS = {
    "segplot": lambda mod, path, args: mod.segplot(path, *args),
    "segplot_indexed": lambda mod, path, args: mod.segplot_indexed(path, *args, 7),
    "segplot_blackwhite": lambda mod, path, args: mod.segplot_blackwhite(path, *args,
                                                                         indx=3),
}


@pytest.mark.parametrize("matplotlib", [True, False], ids=["matplotlib", "own_writer"])
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_segplot_writes_the_jax_files_byte_for_byte(tmp_path, monkeypatch, variant,
                                                    matplotlib):
    if not matplotlib:
        # an import of matplotlib.pyplot raises: both fall back to their writer
        monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    args = _inputs(1)
    for name, mod in (("jax", jax_segplot), ("torch", torch_segplot)):
        _VARIANTS[variant](mod, tmp_path / name, args)
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == want
    assert want and (variant != "segplot" or len(want) == 7)
    for name in want:
        got = (tmp_path / "torch" / name).read_bytes()
        assert got[:8] == b"\x89PNG\r\n\x1a\n", name
        assert got == (tmp_path / "jax" / name).read_bytes(), name


def test_hsv_to_rgb_and_composite_equal_the_jax_ones():
    rng = np.random.default_rng(0)
    hsv = rng.random((3, 64, 64))
    np.testing.assert_array_equal(torch_segplot.hsv_to_rgb(*hsv),
                                  jax_segplot.hsv_to_rgb(*hsv))
    _, image, pred, gt, *_ = _inputs(2, lim=32)
    np.testing.assert_array_equal(torch_segplot._composite(image[..., 0], pred, gt),
                                  jax_segplot._composite(image[..., 0], pred, gt))
