"""``run.profile`` and ``utils.profiling``, and the config levers the port
now honours, on the CPU.

* the parameter count of every registry model equal to the JAX package's
  ``param_count`` of the same model (its variable shapes from
  ``jax.eval_shape`` of ``init``: no compute), but where a model declares
  parameters on one side only, named here with the reason;
* the FLOPs of ENet at 64x64, B=1: equal to the products of its
  convolutions worked out from their shapes (module hooks on a CPU
  forward), the same on the meta device as under a real CPU forward, and
  within a stated ratio of XLA's ``cost_analysis`` of JAX's ENet (which
  counts by its own model);
* ``--memory`` off the card prints "not measured", and the step it would
  time runs;
* ``utils.profiling`` on the CPU;
* ``check_supported`` accepts ``depth_mode``, ``fuse_expand_bn``,
  ``decoder_remat`` and ``decoder_chunk`` and still refuses ``mesh_shape``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from corrifnet_tpu_torch.models.registry import available_models
from corrifnet_tpu_torch.nn import Conv, ConvTranspose, Dense
from corrifnet_tpu_torch.run import profile
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# parameters one side declares and the other does not, by model
_ONE_SIDED = {
    # JAX's mmformer inherits MMVit2's per-modality qkv projections, which its
    # forward never uses; the reference's mmformer, and the port's, have none
    "mmformer": -3 * (512 * 1536 + 1536),
}
# XLA's cost analysis of ENet's forward counts by its own model (elementwise
# work included, its convolutions by its own rule): the port's count of the
# products is compared with it as this ratio only (measured 1.0520 at 64x64,
# B=1)
ENET_XLA_SHARE = (1.0, 1.1)


@pytest.mark.parametrize("name", available_models())
def test_param_count_matches_jax(name):
    from corrifnet_tpu.models import create_model as jax_create_model
    from corrifnet_tpu.models import get_spec as jax_get_spec
    from corrifnet_tpu.run.profile import param_count as jax_param_count

    x = jnp.zeros((1, 3, 3, 64, 64) if jax_get_spec(name).input_kind == "5d"
                  else (1, 3, 64, 64), jnp.float32)
    jm = jax_create_model(name)
    shapes = jax.eval_shape(lambda r, xx: jm.init({"params": r}, xx, False),
                            jax.random.PRNGKey(0), x)
    want = jax_param_count(shapes["params"])
    got = profile.param_count(profile.meta_model(name))
    assert got - want == _ONE_SIDED.get(name, 0), (got, want)


def _products_from_shapes(model, x):
    """2 x the multiply-adds of every convolution and linear layer of one
    forward, from the shapes the layers see (module hooks)."""
    total = []

    def hook(mod, args, out):
        (inp,) = args[:1]
        if isinstance(mod, ConvTranspose):
            cin, cout, *k = mod.weight.shape
            total.append(2 * inp.shape[0] * math.prod(inp.shape[2:]) * cin * cout * math.prod(k))
        elif isinstance(mod, Conv):
            co, ci_g, *k = mod.weight.shape
            total.append(2 * out.shape[0] * math.prod(out.shape[2:]) * co * ci_g * math.prod(k))
        else:
            co, ci = mod.weight.shape
            total.append(2 * (out.numel() // co) * co * ci)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, ConvTranspose, Dense))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return sum(total), len(total)


def test_enet_flops_are_its_products_on_every_device():
    from corrifnet_tpu_torch.models import create_model

    counted = profile.flops(profile.meta_model("ENet"), profile.sample_input("ENet", 1, 64))
    model = create_model("ENet")
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 3, 64, 64))
                         .astype(np.float32))
    want, layers = _products_from_shapes(model, x)
    assert layers > 50
    assert counted == want
    with torch.no_grad(), FlopCounterMode(display=False) as cpu:
        model(x)
    assert cpu.get_total_flops() == counted
    r = profile.profile_model("ENet", 1, 64, device="cpu")
    assert r["flops"] == counted and r["flop_path"] == profile.FLOP_PATH


def test_enet_flops_against_xla_cost_analysis():
    from corrifnet_tpu.models import create_model as jax_create_model
    from corrifnet_tpu.run.profile import flops as jax_flops

    jm = jax_create_model("ENet")
    x = jnp.zeros((1, 3, 64, 64), jnp.float32)
    # the count does not read the values: zeros of init's shapes
    shapes = jax.eval_shape(lambda r, xx: jm.init({"params": r}, xx, False),
                            jax.random.PRNGKey(0), x)
    variables = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    share = profile.profile_model("ENet", 1, 64)["flops"] / jax_flops(jm, variables, x)
    assert ENET_XLA_SHARE[0] <= share <= ENET_XLA_SHARE[1], share


def test_memory_is_not_measured_on_the_cpu(capsys):
    r = profile.main(["ENet", "--memory", "--lim", "32", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"ENet: params {r['params_str']}  flops {r['flops_str']}  "
                        "train-step peak not measured")
    assert lines[1] == profile.FLOP_PATH
    assert r["train_step_memory"] is None
    metrics = profile.training_step("ENet", 2, 32, "cpu", "float32")()
    assert metrics.shape == (3,) and bool(torch.isfinite(metrics).all())
    assert float(metrics[2]) == 2.0


def test_utils_profiling_on_the_cpu(tmp_path):
    from corrifnet_tpu_torch.utils import profiling

    assert profiling.device_memory_stats("cpu") == {}
    assert profiling.live_tensor_bytes("cpu") == 0
    with profiling.trace(tmp_path / "t"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("field,value", [("depth_mode", "pruned"), ("fuse_expand_bn", True),
                                         ("decoder_remat", True), ("decoder_chunk", 8),
                                         ("mesh_shape", [1, 1])])
def test_check_supported_takes_the_levers_and_refuses_the_mesh(field, value, capsys):
    from corrifnet_tpu_torch.config import ExperimentConfig, check_supported

    cfg = ExperimentConfig(**{field: value})
    if field == "mesh_shape":
        with pytest.raises(NotImplementedError, match=r"mesh_shape=.*ROADMAP\.md"):
            check_supported(cfg, "cuda")
    else:
        check_supported(cfg, "cuda")
        assert capsys.readouterr().out == ""
