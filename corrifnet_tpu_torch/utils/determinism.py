"""Deterministic execution for the span of one entry point's run.

The JAX package's training repeats its bits: XLA's programs on one device
and one compiler version compute in a fixed order. PyTorch on a GPU does
not by default: cuDNN picks algorithms by heuristics or timing, some of
them accumulating with atomics, and several library backwards (the linear
resizes', replicate padding's, max pooling's) scatter with atomics. The
port gives those ops backwards of its own in a fixed order
(``nn/resize.py``, ``nn/pad.py``), and ``deterministic()`` turns on
PyTorch's own guarantees around a run:

  * ``torch.use_deterministic_algorithms(True)``: an op that has no
    deterministic implementation raises, naming itself, instead of running;
  * ``torch.backends.cudnn.deterministic = True`` and
    ``torch.backends.cudnn.benchmark = False``: cuDNN's deterministic
    algorithms only, chosen without timing;
  * ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` where it is unset, which PyTorch
    asks for before it runs cuBLAS in deterministic mode;
  * ``torch.utils.deterministic.fill_uninitialized_memory = False``: with
    deterministic algorithms PyTorch fills every new allocation with NaN,
    so that a read of memory nothing wrote repeats its bits too. No op of
    the port reads such memory (two identical runs are equal without the
    fill, ``chip_smoke.py`` phases 11-13), and the fill costs about 2,000
    launches a B=4 step on an H100 (2,030 fill kernels, 5.3 ms of device
    time, in a MMVit2 step).

The caller's settings come back on exit, so that code around a run (a
benchmark of library calls, a plain version used as a yardstick) runs as
it would without it. The same settings apply on every device, so the CPU
takes the code path the card takes.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["CUBLAS_WORKSPACE", "deterministic"]

CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic(warn_only: bool = False):
    """Run the body under PyTorch's deterministic settings and restore the
    caller's after it. ``warn_only`` warns, instead of raising, at each op
    without a deterministic implementation (a probe that lists them all)."""
    fill = torch.utils.deterministic
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             fill.fill_uninitialized_memory)
    set_workspace = "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    if set_workspace:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    fill.fill_uninitialized_memory = False
    try:
        yield
    finally:
        enabled, was_warn_only, cudnn_det, cudnn_bench, fill_memory = saved
        torch.use_deterministic_algorithms(enabled, warn_only=was_warn_only)
        torch.backends.cudnn.deterministic = cudnn_det
        torch.backends.cudnn.benchmark = cudnn_bench
        fill.fill_uninitialized_memory = fill_memory
        if set_workspace:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
