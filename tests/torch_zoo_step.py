"""The bounds of a zoo model's training step, port against JAX, on the CPU.

Shared by ``tests/test_torch_rfnet.py`` and ``tests/test_torch_robustseg.py``:
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
