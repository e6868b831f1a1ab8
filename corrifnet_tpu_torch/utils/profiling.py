"""Device memory and tracing helpers (counterpart of ``corrifnet_tpu/utils/profiling.py``).

  * ``device_memory_stats(device)``: the caching allocator's counters of a
    CUDA device (``torch.cuda.memory_stats``), an empty dict elsewhere, as
    the JAX helper returns one on a backend without them;
  * ``live_tensor_bytes(device)``: the bytes the allocator holds for live
    tensors (``torch.cuda.memory_allocated``), 0 off the card;
  * ``trace(log_dir)``: ``torch.profiler`` over a region, written to
    ``log_dir`` as a Chrome trace (``trace.json``), the card's kernels with
    the host's ops where a CUDA device is there.

FLOPs and parameter counts are ``run.profile``'s.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict

import torch

__all__ = ["device_memory_stats", "live_tensor_bytes", "trace"]


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def device_memory_stats(device="cuda") -> Dict[str, int]:
    """The allocator's statistics of ``device`` (bytes and counts), or an
    empty dict for a device that has none (the CPU)."""
    if not _on_card(device):
        return {}
    return dict(torch.cuda.memory_stats(device))


def live_tensor_bytes(device="cuda") -> int:
    """Bytes in use by live tensors on ``device``, 0 for the CPU."""
    if not _on_card(device):
        return 0
    return int(torch.cuda.memory_allocated(device))


@contextlib.contextmanager
def trace(log_dir):
    """Profile a region and write ``log_dir/trace.json`` (Chrome format)::

        with trace("build/trace"):
            step(images, masks, valid, lr)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
