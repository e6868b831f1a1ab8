"""``scripts/export_jax_checkpoint.py``: a JAX run's orbax checkpoint into
the port, on the CPU.

A JAX run directory (the stand-in ``TinySeg5D``, 5-D, registered in both
packages, and ENet, with BatchNorm statistics) holding
``Finaliremmodel{i}`` goes through the export script to an ``.npz`` whose
arrays are the saved variables bit for bit; the port's ``load_weights``
reads it, and the port's forward equals JAX's within ``MODEL_ATOL``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import registry as jax_registry
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import create_model
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.run import evaluate
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_tiny_model import jax_params, port_state_dict, registered  # noqa: F401
from torch_zoo_cli import MODEL_ATOL

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "export_jax_checkpoint.py"


def _script():
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_model(name):
    if name == "ENet":
        from corrifnet_tpu.models.enet import ENet

        return ENet(dtype=jnp.float32)
    from test_resume import TinySeg5D

    return TinySeg5D()


@pytest.mark.parametrize("name,index,shape", [("TinySeg5D", 1, (2, 3, 3, 32, 32)),
                                              ("ENet", 0, (1, 3, 64, 64))])
def test_export_round_trip_matches_jax(tmp_path, monkeypatch, registered, name, index,  # noqa: F811
                                       shape):
    from corrifnet_tpu.train import Checkpointer
    from test_resume import TinySeg5D as JaxTinySeg5D

    monkeypatch.setitem(jax_registry._REGISTRY, "TinySeg5D", jax_registry.ModelSpec(
        "TinySeg5D", JaxTinySeg5D, "5d", "test stand-in", True))
    monkeypatch.setitem(evaluate._CONVERTERS, "TinySeg5D",
                        lambda v: port_state_dict(v["params"]))
    sd = dict(create_model(name, seed=4).state_dict())
    variables = (ti.enet_variables_from_state_dict(sd) if name == "ENet"
                 else {"params": jax_params(sd), "batch_stats": {}})
    ck = Checkpointer(str(tmp_path / "run"))
    try:
        ck.save(f"Finaliremmodel{index}", variables["params"], variables["batch_stats"])
    finally:
        ck.close()
    (tmp_path / "cfg.json").write_text(json.dumps({"modeltype": name, "dtype": "float32"}))

    out = tmp_path / "w.npz"
    assert _script().main(["--config", str(tmp_path / "cfg.json"), "--run-dir",
                           str(tmp_path / "run"), "--index", str(index), "--out", str(out)]) == 0
    want = flatten_variables(variables)
    with np.load(out) as z:
        assert sorted(z.files) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(z[key], value, err_msg=key)

    model = create_model(name)
    model.load_state_dict(evaluate.load_weights(out, name), strict=True)
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    expect = np.asarray(jax.jit(lambda v, xx: _jax_model(name).apply(v, xx, False))(
        variables, jnp.asarray(x)))
    assert got.shape == expect.shape
    err = np.abs(got - expect).max()
    print(f"{name}: the exported weights' forward against JAX's: {err}")
    assert err <= MODEL_ATOL
