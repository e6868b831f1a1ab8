"""LR schedule matching the reference's StepLR usage (F4_TRAIN.py:46).

Counterpart of ``corrifnet_tpu/train/schedule.py``. The reference calls
``scheduler.step()`` at the *start* of every epoch, so during epoch ``e``
the optimizer runs at

    lr(e) = base_lr * gamma ** ((e + 1) // step_size)

while the value it prints, ``scheduler.get_lr()``, carries an extra
``* gamma`` at boundary epochs (``(e + 1) % step_size == 0``). Both are
given, so the log files keep the reference's format.
"""

from __future__ import annotations

__all__ = ["step_lr", "step_lr_reported"]


def step_lr(base_lr: float, step_size: int, gamma: float, epoch: int) -> float:
    """The LR the optimizer uses during ``epoch`` (0-based)."""
    return base_lr * gamma ** ((epoch + 1) // step_size)


def step_lr_reported(base_lr: float, step_size: int, gamma: float, epoch: int) -> float:
    """What the reference prints and logs for ``epoch`` (the get_lr() quirk)."""
    last_epoch = epoch + 1
    lr = base_lr * gamma ** (last_epoch // step_size)
    if last_epoch % step_size == 0 and last_epoch > 0:
        lr *= gamma
    return lr
