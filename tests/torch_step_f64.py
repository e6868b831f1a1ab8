"""One whole MMVit4 train step, and two Adam steps, in float64 on both sides.

    env JAX_PLATFORMS=cpu python tests/torch_step_f64.py

Run in a process of its own by ``tests/test_torch_train.py``
(``test_train_step_matches_jax_in_f64``), because it changes both libraries
for the whole process; prints one JSON object on its last line.

In f32 the gradient of this network at random initialization is too badly
conditioned to hold the port against JAX tensor by tensor (some forty
ReLU+normalization layers in sequence amplify rounding). In f64 the same
amplification leaves differences near 1e-11, so here every gradient tensor,
the parameters and the running statistics are held to tight bounds. To
compute in f64 throughout:

  * JAX: ``jax_enable_x64``, and ``jax.numpy.float32`` is made to name
    float64 before flax and the JAX package are imported, so that their
    ``astype(jnp.float32)`` casts and ``param_dtype`` defaults become f64;
    its interpolation matrices, built with ``np.float32``, likewise;
  * the port: ``model.double()`` and ``Tensor.float`` made ``Tensor.double``
    (the plain versions and the norms cast with ``.float()``); PyTorch's
    f64 ``conv3d`` on the CPU is given its input in slabs, to bound memory.

One case, B=1 (the decoder works on 128^3 volumes whatever the input size,
so a larger batch in f64 takes tens of GiB); the object holds the measured
differences, see ``measure``.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
import resource
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)
jnp.float32 = jnp.float64
torch.Tensor.float = lambda self, *a, **k: self.double()

_conv3d = torch.nn.functional.conv3d
COLUMN_VALUES = 2 ** 26  # 0.5 GiB of f64


def conv3d_in_slabs(x, weight, bias=None, stride=1, padding=0):
    """``F.conv3d`` with the same result. PyTorch's f64 conv3d on the CPU
    unfolds its whole input into columns (14 GB for one decoder conv at
    128^3); a large stride-1 conv is computed here in slabs of output depth,
    so that the columns of one call stay under ``COLUMN_VALUES``."""
    triple = lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3  # noqa: E731
    stride, (pd, ph, pw) = triple(stride), triple(padding)
    kd = weight.shape[2]
    columns = weight[0].numel() * x[0, 0].numel()
    if stride != (1, 1, 1) or columns <= COLUMN_VALUES:
        return _conv3d(x, weight, bias, stride, (pd, ph, pw))
    if pd:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, pd, pd))
    out_depth = x.shape[2] - kd + 1
    size = max(1, out_depth // math.ceil(columns / COLUMN_VALUES))
    return torch.cat([_conv3d(x[:, :, d:d + size + kd - 1], weight, bias, 1, (0, ph, pw))
                      for d in range(0, out_depth, size)], dim=2)


torch.nn.functional.conv3d = conv3d_in_slabs

import optax  # noqa: E402

import corrifnet_tpu.nn.resize as jax_resize  # noqa: E402
from corrifnet_tpu.models.mmvit4 import MMVit4 as JaxMMVit4  # noqa: E402
from corrifnet_tpu.models.torch_import import mmvit4_variables_from_state_dict  # noqa: E402
from corrifnet_tpu.train.state import _masked_loss_and_jaccard  # noqa: E402
from corrifnet_tpu_torch.models import (  # noqa: E402
    create_model, mmvit4_named_gradients, mmvit4_state_dict_from_variables)
from corrifnet_tpu_torch.testing import calibrate_batchnorm  # noqa: E402
from corrifnet_tpu_torch.train import init_state, make_train_step  # noqa: E402

LR = 1e-4


class _NumpyInF64:
    """numpy, with float32 naming float64."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


# the interpolation matrices of the JAX package are built with numpy
jax_resize.np = _NumpyInF64()


def step_inputs(batch):
    """The inputs of ``test_train_step_matches_jax`` without padding (same seed)."""
    rng = np.random.default_rng(130 + batch)
    x = rng.normal(0, 1, (batch, 3, 3, 64, 64)).astype(np.float32)
    masks = (rng.random((batch, 3, 1, 224, 224)) > 0.7).astype(np.float32)
    return tuple(a.astype(np.float64) for a in (x, masks, np.ones(batch)))


def to_f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def peak_rss_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def release_memory():
    """Drop what the side that just ran still holds, back to the system."""
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def port_model(batch):
    """MMVit4 of the port with calibrated BatchNorm statistics, f32 values."""
    model = create_model("MMVit4", dtype=torch.float64, device="cpu", seed=0,
                         transformer_dropout=0.0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_pos"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    calibrate_batchnorm(model, torch.from_numpy(batch[0]).to(torch.float32))
    return model


def port_steps(model, batch):
    """Two Adam steps of the port in f64: the two losses, the first step's
    gradients and the final state_dict, as numpy arrays."""
    model.double()
    step = make_train_step(init_state(model, "Adam"))
    losses, grads = [], None
    for _ in range(2):
        losses.append(step(*map(torch.from_numpy, batch), LR)[0].item())
        if grads is None:
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                     if p.grad is not None}
    after = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return losses, grads, after


def jax_steps(start, batch):
    """The same two steps in the JAX package (XLA paths, standard decoder
    chain): the two losses, the first gradients under the port's names and
    the final state under the port's names."""
    variables = mmvit4_variables_from_state_dict(start, pack_stage1=True)
    params, stats = to_f64(variables["params"]), to_f64(variables["batch_stats"])
    batch = tuple(jnp.asarray(a, jnp.float64) for a in batch)
    jm = JaxMMVit4(dtype=jnp.float64, use_pallas=False, decoder_lean=False,
                   transformer_dropout=0.0)

    def loss_fn(params, batch_stats, images, masks, valid):
        out, mut = jm.apply({"params": params, "batch_stats": batch_stats}, images,
                            True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        loss, _, _ = _masked_loss_and_jaccard(out.astype(jnp.float64), masks, valid)
        return loss, mut["batch_stats"]

    jax_step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    opt_state = adam.init(params)
    losses, first = [], None
    for _ in range(2):
        (loss, stats), grads = jax_step(params, stats, *batch)
        assert all(g.dtype == jnp.float64 for g in jax.tree.leaves(grads))
        losses.append(float(loss))
        if first is None:
            first = {k: v.numpy() for k, v in mmvit4_named_gradients(
                jax.tree.map(np.asarray, grads)).items()}
        updates, opt_state = adam.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p - LR * u, params, updates)
    after = mmvit4_state_dict_from_variables(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, stats)})
    return losses, first, {k: v.numpy() for k, v in after.items()}


def measure(batch_size):
    """Two train steps on both sides from the same weights and batch, one
    side after the other so that their memory adds up less. Returns, for
    step 1: |loss - loss_jax| and the worst gradient tensor's
    max|g - g_jax| / max|g_jax| (``grad_abs_where_jax_is_zero``: the largest
    entry of the port's gradient where JAX's whole tensor is 0); after step
    2: |loss - loss_jax|, the worst max|p - p_jax| / max|p_jax| over the
    parameter tensors, the worst |p - p_jax| in units of the largest move
    two Adam steps can make (2 lr), and the worst relative difference of
    the BatchNorm running statistics."""
    batch = step_inputs(batch_size)
    model = port_model(batch)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    losses_j, want, after_j = jax_steps(start, batch)
    release_memory()
    t1 = time.perf_counter()
    jax_rss = peak_rss_gib()
    losses, got, after = port_steps(model, batch)
    t2 = time.perf_counter()
    assert all(g.dtype == np.float64 for g in got.values())
    # parameters without a gradient here (fusion5, unused) have none in JAX
    assert all(np.abs(want[n]).max() == 0 for n in want if n not in got)
    rel, zero = {}, 0.0
    for n, g in got.items():
        scale = np.abs(want[n]).max()
        if scale == 0:
            zero = max(zero, float(np.abs(g).max()))
        else:
            rel[n] = float(np.abs(g - want[n]).max() / scale)
    worst = max(rel, key=rel.get)
    param_rel = move_rel = stats_rel = 0.0
    for n, a in after.items():
        if not np.issubdtype(a.dtype, np.floating):
            continue
        diff = float(np.abs(a - after_j[n]).max())
        scale = max(float(np.abs(after_j[n]).max()), 1e-30)
        if "running_" in n:
            stats_rel = max(stats_rel, diff / scale)
        else:
            param_rel = max(param_rel, diff / scale)
            move_rel = max(move_rel, diff / (2 * LR))
            assert np.abs(a - start[n].numpy()).max() <= 2 * LR * 1.001
    return dict(
        loss_diff_1=abs(losses[0] - losses_j[0]), loss_diff_2=abs(losses[1] - losses_j[1]),
        loss_1=losses[0], grad_tensors=len(rel), grad_rel_worst=rel[worst],
        grad_rel_worst_at=worst, grad_abs_where_jax_is_zero=zero,
        param_rel_worst=param_rel, move_rel_worst=move_rel, stats_rel_worst=stats_rel,
        jax_seconds=t1 - t0, port_seconds=t2 - t1, jax_peak_rss_gib=jax_rss,
        peak_rss_gib=peak_rss_gib())


def main():
    print(json.dumps({"B=1": measure(1)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
