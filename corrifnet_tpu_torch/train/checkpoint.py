"""Checkpoints of the model's ``state_dict`` (reference: torch.save/load).

Counterpart of ``corrifnet_tpu/train/checkpoint.py`` (``epoch_ckpt_name``,
``final_ckpt_name``, ``Checkpointer.save/restore/save_state/restore_state/
exists``). The reference saves ``model.state_dict()`` every epoch as
``iremmodel{i}`` (F4_TRAIN.py:84) and at the end as ``Finaliremmodel{i}``
(:86), and never the optimizer state. A checkpoint here is ``torch.save`` of
the ``state_dict`` (parameters and BatchNorm buffers, on the CPU), written
under a temporary name and renamed, so an interrupted save leaves the
previous file whole. The extended checkpoint ``state{i}`` (a capability the
reference lacks) is ``torch.save`` of ``TrainState.state_dict()`` in
generations ``state{i}@{step}``, as the JAX package keeps them.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

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

    def save(self, name: str, model) -> Path:
        """``model``'s ``state_dict`` (or ``model`` itself, a ``state_dict``)
        as ``{name}``, on the CPU."""
        path = self.run_dir / name
        tmp = self.run_dir / f"{name}.{os.getpid()}.tmp"
        sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
        state = {k: v.detach().cpu() for k, v in sd.items()}
        torch.save(state, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, name: str):
        """The saved ``state_dict``, on the CPU."""
        return torch.load(self.run_dir / name, map_location="cpu", weights_only=True)

    def save_state(self, name: str, state) -> Path:
        """The whole ``TrainState`` as ``{name}@{step}``, for a resume.

        Each save is a new generation, written under a temporary name and
        renamed; older generations, a legacy plain ``{name}`` and stale
        temporaries are removed only once the new file is in place, so a
        kill at any instant leaves at least one whole resume point."""
        path = self.run_dir / f"{name}@{state.step}"
        tmp = self.run_dir / f"{path.name}.{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        for old in self.run_dir.glob(f"{name}@*"):
            if old != path:
                old.unlink(missing_ok=True)
        (self.run_dir / name).unlink(missing_ok=True)
        return path

    def _resolve_state(self, name: str) -> Optional[Path]:
        """The newest whole resume point: the highest-step ``{name}@N``,
        else a legacy plain ``{name}``; temporaries never match."""
        best, best_step = None, -1
        for p in self.run_dir.glob(f"{name}@*"):
            tail = p.name.rsplit("@", 1)[1]
            if tail.isdigit() and int(tail) > best_step:
                best, best_step = p, int(tail)
        if best is not None:
            return best
        legacy = self.run_dir / name
        return legacy if legacy.exists() else None

    def restore_state(self, name: str, state):
        """Load the newest ``{name}`` resume point into ``state`` in place."""
        path = self._resolve_state(name)
        if path is None:
            raise FileNotFoundError(self.run_dir / name)
        return state.load_state_dict(
            torch.load(path, map_location="cpu", weights_only=True))

    def exists(self, name: str) -> bool:
        return (self.run_dir / name).exists() or self._resolve_state(name) is not None
