"""Checkpoints of the model's ``state_dict`` (reference: torch.save/load).

Counterpart of ``corrifnet_tpu/train/checkpoint.py`` (``epoch_ckpt_name``,
``final_ckpt_name``, ``Checkpointer.save/restore/exists``). The reference
saves ``model.state_dict()`` every epoch as ``iremmodel{i}`` (F4_TRAIN.py:84)
and at the end as ``Finaliremmodel{i}`` (:86), and never the optimizer
state. A checkpoint here is ``torch.save`` of the ``state_dict`` (parameters
and BatchNorm buffers, on the CPU), written under a temporary name and
renamed, so an interrupted save leaves the previous file whole.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

__all__ = ["Checkpointer", "epoch_ckpt_name", "final_ckpt_name"]


def epoch_ckpt_name(i: int) -> str:
    return f"iremmodel{i}"


def final_ckpt_name(i: int) -> str:
    return f"Finaliremmodel{i}"


class Checkpointer:
    """Saves and restores ``state_dict`` files in one run directory."""

    def __init__(self, run_dir):
        self.run_dir = Path(run_dir).resolve()
        self.run_dir.mkdir(parents=True, exist_ok=True)

    def save(self, name: str, model: torch.nn.Module) -> Path:
        path = self.run_dir / name
        tmp = self.run_dir / f"{name}.{os.getpid()}.tmp"
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save(state, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, name: str):
        """The saved ``state_dict``, on the CPU."""
        return torch.load(self.run_dir / name, map_location="cpu", weights_only=True)

    def exists(self, name: str) -> bool:
        return (self.run_dir / name).exists()
