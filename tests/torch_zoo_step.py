"""The bounds of a zoo model's training step, port against JAX, on the CPU.

Shared by the zoo models' test files (``tests/test_torch_rfnet.py``,
``tests/test_torch_robustseg.py``, ``tests/test_torch_multisenseseg.py``,
``tests/test_torch_unet.py``):
``hold_step`` holds the port's gradients ``got`` against JAX's ``want`` (both
{port parameter name: array}) to N1's f32 bounds (ROADMAP Queue 3: the
cosine of the whole gradient >= 0.97, every tensor within 0.4 of its norm),
and every tensor within twice the worst that the port shows against itself
under a 1e-6 change of the input (``moved``, the witness). A tensor outside
that is held against the port's step in float64 (``port_step`` run again
with every ``.float()`` a ``.double()``): the port's distance to it within
twice the larger of JAX's distance and the witness. The tensors named in
``zero`` have a gradient of 0 but for rounding (a conv bias that feeds an
InstanceNorm, which takes its mean out): they are held by size instead.

``CallOrderMasks`` gives both packages the same dropout masks in call order;
``jax_reinitialized`` and ``hold_scheme_std`` hold the ``notr``
re-initialization to the JAX package's choice of tensors and to each
scheme's standard deviation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ZERO_NOISE = 2e-4  # of the largest gradient entry (RFNet, oneDNN: 8.0e-5)


def agreement(got, want):
    """(cosine over all tensors, (worst per-tensor ||got - want|| / ||want||,
    its name))."""
    dot = sum(float((got[n] * want[n]).sum()) for n in want)
    norms = math.sqrt(sum(float((got[n] ** 2).sum()) for n in want)
                      * sum(float((want[n] ** 2).sum()) for n in want))
    worst = max((float(np.linalg.norm(got[n] - want[n])
                       / max(np.linalg.norm(want[n]), 1e-30)), n) for n in want)
    return dot / norms, worst


def _distance(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def hold_step(name, model, port_step, x, got, want, moved, monkeypatch, zero=(),
              tensor_bound=None):
    """Assert the bounds above; ``port_step(x)`` returns (loss, gradients).
    With ``tensor_bound``, every tensor is held to it instead of to the
    witness and float64 (where the step in float64 on the CPU is too large
    to run beside the other tests)."""
    scale = max(float(np.abs(v).max()) for v in want.values())
    noise = max([float(np.abs(g[n]).max()) for g in (got, want) for n in zero] or [0.0])
    assert noise <= ZERO_NOISE * scale, (noise / scale, len(zero))
    live = [n for n in got if n not in zero]
    cosine, worst = agreement({n: got[n] for n in live}, {n: want[n] for n in live})
    _, witness = agreement({n: moved[n] for n in live}, {n: got[n] for n in live})
    print(f"{name} train step against JAX: cosine {cosine}, worst {worst}, witness "
          f"{witness}, zero-gradient noise {noise / scale}")
    assert cosine >= 0.97 and worst[0] <= 0.4, (cosine, worst)
    if tensor_bound is not None:
        assert worst[0] <= tensor_bound, (worst, tensor_bound)
        return
    outside = [n for n in live if _distance(got[n], want[n]) > 2 * witness[0]]
    if not outside:
        return
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
    model.double().compute_dtype = torch.float64
    try:
        _, ref = port_step(x.astype(np.float64))
    finally:
        monkeypatch.undo()
        model.float().compute_dtype = torch.float32
    far = {n: (_distance(got[n], ref[n]), _distance(want[n], ref[n])) for n in outside}
    far = {n: d for n, d in far.items() if d[0] > 2 * max(d[1], witness[0])}
    print(f"  {len(outside)} tensors outside twice the witness; far from float64: {far}")
    assert not far, far


class CallOrderMasks:
    """Dropout keep masks answered in call order from one table, the same on
    both sides: the i-th call of a side gets the mask drawn from seed
    ``(seed, i)`` at its shape, kept where the draw is under the keep
    probability. The port's side stands in for the model's ``DropoutRng``
    (``keep(x, rate)``); the JAX side replaces ``jax.random.bernoulli(key,
    p, shape)``. Each side records its (shape, keep probability) calls, which
    must be the same lists. ``channels_last``: the JAX model's tensors are
    channels-last where the port's NCHW are (UNetV2), so the port's side
    draws in the JAX layout and moves the channels back."""

    def __init__(self, seed, channels_last=False):
        self.seed = seed
        self.channels_last = channels_last
        self.calls = []

    def _mask(self, shape, p):
        i = len(self.calls)
        self.calls.append((tuple(int(s) for s in shape), float(p)))
        return np.random.default_rng((self.seed, i)).random(tuple(shape)) < p

    def keep(self, x, rate):
        if not self.channels_last:
            return torch.from_numpy(self._mask(x.shape, 1.0 - rate))
        shape = (x.shape[0], *x.shape[2:], x.shape[1])
        return torch.from_numpy(np.moveaxis(self._mask(shape, 1.0 - rate), -1, 1).copy())

    def bernoulli(self, key, p, shape):
        import jax.numpy as jnp

        return jnp.asarray(self._mask(shape, p))


def jax_reinitialized(jax_shapes, to_state_dict):
    """The port names of the tensors that the JAX package's ``notr``
    re-initializes (``corrifnet_tpu/nn/init.py:107-139``): its 4-axis
    ``kernel`` leaves and the ``bias`` leaves beside them (zeroed), marked
    in a tree of ``jax_shapes`` and converted by ``to_state_dict``."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(jax_shapes)[0]
    conv_dirs = {tuple(p.key for p in path[:-1]) for path, s in flat
                 if path[-1].key == "kernel" and len(s.shape) == 4}

    def mark(path, s):
        keys = tuple(p.key for p in path)
        hit = keys[:-1] in conv_dirs and keys[-1] in ("kernel", "bias")
        return np.full(s.shape, float(hit), np.float32)

    sd = to_state_dict({"params": jax.tree_util.tree_map_with_path(mark, jax_shapes)})
    return {n for n, v in sd.items() if v.any()}


# scheme: (normal, the std of a (out, in, kh, kw) weight from its fans)
SCHEMES = {"xavier_uniform_": (False, lambda fi, fo: math.sqrt(2.0 / (fi + fo))),
           "xavier_normal_": (True, lambda fi, fo: math.sqrt(2.0 / (fi + fo))),
           "kaiming_uniform_": (False, lambda fi, fo: math.sqrt(2.0 / fi)),
           "kaiming_normal_": (True, lambda fi, fo: math.sqrt(2.0 / fi))}


def hold_scheme_std(scheme, weights):
    """The mean of (w / std)^2 over ``weights`` ((out, in, kh, kw) tensors)
    is 1 within five standard errors (its variance per entry: 2 for a
    normal draw, 4/5 for a uniform one)."""
    normal, std = SCHEMES[scheme]
    sq, count = 0.0, 0
    for w in weights:
        w = w.detach().double()
        fi, fo = w.shape[1] * w[0, 0].numel(), w.shape[0] * w[0, 0].numel()
        sq += float(((w / std(fi, fo)) ** 2).sum())
        count += w.numel()
    mean = sq / count
    assert abs(mean - 1.0) <= 5 * math.sqrt((2.0 if normal else 0.8) / count), (mean, count)
