"""Training, validation and test loops (reference: F4_TRAIN.py, F7_TEST2.py).

Counterpart of ``corrifnet_tpu/train/loop.py``. Per epoch
(F4_TRAIN.py:39-86): the epoch-start-stepped StepLR value is logged, every
batch takes one train step while batch losses and batchLoad-weighted
Jaccard2 accumulate, the epoch checkpoint ``iremmodel{i}`` is written and
validation runs; after all epochs ``Finaliremmodel{i}`` is saved.
Validation keeps the reference's restore-every-epoch semantics: it loads
the checkpoint just written into a second copy of the model
(F4_TRAIN.py:96-180) behind ``val_from_checkpoint``. The test
(F7_TEST2.py:38-184) restores the final checkpoint, accumulates loss and
Jaccard over the test fold and measures wall-clock FPS.

Host and device overlap: a batch is copied from pinned host memory with
``non_blocking=True``, and the three metric scalars of step i are fetched
only after step i+1 has been launched, so the host's read does not leave
the card idle at every step. Dropout randomness is made anew per epoch from
(seed, epoch), so the stream does not depend on how many epochs ran in the
process.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np
import torch

from corrifnet_tpu_torch.data.dataset import make_batches
from corrifnet_tpu_torch.nn import DropoutRng
from corrifnet_tpu_torch.train.checkpoint import (
    Checkpointer,
    epoch_ckpt_name,
    final_ckpt_name,
)
from corrifnet_tpu_torch.train.schedule import step_lr, step_lr_reported
from corrifnet_tpu_torch.train.state import (
    TrainState,
    make_eval_step,
    make_train_step,
)
from corrifnet_tpu_torch.utils.logfiles import RunLogs

__all__ = ["epoch_dropout_seed", "train_model", "validate", "test_model"]


def epoch_dropout_seed(seed: int, epoch: int) -> int:
    """The dropout seed of ``epoch``: a function of (seed, epoch) alone."""
    return (int(seed) * 1_000_003 + int(epoch) + 1) % (2 ** 63)


def _to_device(array: np.ndarray, device: torch.device):
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _device_batches(images, masks, indices, batch_size, device):
    for batch in make_batches(images, masks, indices, batch_size):
        yield (_to_device(batch.images, device), _to_device(batch.masks, device),
               _to_device(batch.valid, device))


class _MetricSums:
    """Batch losses and batchLoad-weighted Jaccard (F4_TRAIN.py:65-71), fed
    one step late: ``push`` takes the device metrics of the step just
    launched and reads those of the step before."""

    def __init__(self, lim: int):
        self.lim = lim
        self.losses, self.jaccard_sum, self.load = [], 0.0, 0.0
        self._pending = None

    def push(self, metrics):
        previous, self._pending = self._pending, metrics
        if previous is not None:
            loss, jac, n_valid = previous.tolist()
            batch_load = n_valid * self.lim * self.lim
            self.losses.append(loss)
            self.jaccard_sum += jac * batch_load
            self.load += batch_load

    def result(self):
        self.push(None)
        return float(np.mean(self.losses)), self.jaccard_sum / self.load


def _run_eval(model, images, masks, indices, batch_size, lim, device):
    """(mean loss, weighted Jaccard, first batch's outputs as numpy)."""
    if len(indices) == 0:
        raise ValueError(
            "empty evaluation index list (e.g. the validation split rounds "
            "to 0 samples): nothing to evaluate"
        )
    eval_step = make_eval_step(model)
    sums = _MetricSums(lim)
    first_outputs = None
    for im, ma, valid in _device_batches(images, masks, indices, batch_size, device):
        metrics, out = eval_step(im, ma, valid)
        sums.push(metrics)
        if first_outputs is None:
            first_outputs = out
    loss, jac = sums.result()
    return loss, jac, first_outputs.cpu().numpy()


def validate(
    model,
    images,
    masks,
    vlind,
    batch_size,
    lim,
    logs: Optional[RunLogs],
    ckpt: Optional[Checkpointer] = None,
    i: int = 0,
    val_from_checkpoint: bool = True,
    eval_model=None,
):
    """F4_TRAIN.py:90-208. With ``val_from_checkpoint`` and a checkpointer,
    the epoch checkpoint is read back from disk into ``eval_model`` (a copy
    of ``model`` made here when not given) and that copy is evaluated: the
    reference's save/load round trip (:180). Otherwise the live model."""
    device = next(model.parameters()).device
    if val_from_checkpoint and ckpt is not None:
        if eval_model is None:
            eval_model = copy.deepcopy(model)
        eval_model.load_state_dict(ckpt.restore(epoch_ckpt_name(i)), strict=True)
        model = eval_model
    val_loss, val_jac, _ = _run_eval(model, images, masks, vlind, batch_size,
                                     lim, device)
    if logs is not None:
        logs.val.write(str(val_loss) + "\n")
        logs.valacc.write(str(val_jac) + "\n")
        logs.lr.write("Validation loss:" + str(val_loss) + "\n")
        logs.lr.write("Validation accuracy:" + str(val_jac) + "\n")
    print("Validation Jaccard:", val_jac)
    return val_loss, val_jac


def train_model(
    state: TrainState,
    n_epochs: int,
    learn_rate: float,
    step_size: int,
    gamma: float,
    images,
    masks,
    trind,
    vlind,
    batch_size: int,
    lim: int,
    logs: Optional[RunLogs],
    ckpt: Optional[Checkpointer],
    i: int = 0,
    seed: int = 0,
    val_from_checkpoint: bool = True,
):
    """F4_TRAIN.py:39-86 equivalent: trains ``state`` in place and returns
    (state, history). Beside the per-epoch losses and accuracies, the
    history holds ``step_seconds``: the wall seconds between the launches
    of consecutive steps of an epoch (the time one step takes once the
    one-deep metric pipeline is full)."""
    model = state.model
    device = next(model.parameters()).device
    train_step = make_train_step(state)
    eval_model = None
    if val_from_checkpoint and ckpt is not None:
        eval_model = copy.deepcopy(model)

    history = {"train_loss": [], "train_jac": [], "val_loss": [], "val_jac": [],
               "step_seconds": []}
    for epoch in range(n_epochs):
        model.set_dropout_rng(DropoutRng(epoch_dropout_seed(seed, epoch), device))
        lr = step_lr(learn_rate, step_size, gamma, epoch)
        lr_rep = step_lr_reported(learn_rate, step_size, gamma, epoch)
        print("Epoch:", epoch, "LR:", [lr_rep])
        if logs is not None:
            logs.lr.write(f"Epoch: {epoch} LR: [{lr_rep}]\n")
            logs.lr.write(
                str({
                    "step_size": step_size, "gamma": gamma,
                    "base_lrs": [learn_rate], "last_epoch": epoch + 1,
                    "_last_lr": [lr],
                }) + "\n"
            )

        sums = _MetricSums(lim)
        last = None
        for im, ma, valid in _device_batches(images, masks, trind, batch_size, device):
            metrics = train_step(im, ma, valid, lr)
            sums.push(metrics)  # waits for the step before this one
            now = time.perf_counter()
            if last is not None:
                history["step_seconds"].append(now - last)
            last = now
        train_loss, train_jac = sums.result()
        history["train_loss"].append(train_loss)
        history["train_jac"].append(train_jac)
        if logs is not None:
            logs.train.write(str(train_loss) + "\n")
            logs.trainacc.write(str(train_jac) + "\n")
            logs.trainepoch.write(str(epoch) + "\n")
            logs.lr.write("Training loss:" + str(train_loss) + "\n")
            logs.lr.write("Training accuracy:" + str(train_jac) + "\n")
        print("Training Jaccard:", train_jac, " (epoch:", epoch, ")")

        if ckpt is not None:
            ckpt.save(epoch_ckpt_name(i), model)
        val_loss, val_jac = validate(
            model, images, masks, vlind, batch_size, lim, logs, ckpt, i,
            val_from_checkpoint, eval_model=eval_model,
        )
        history["val_loss"].append(val_loss)
        history["val_jac"].append(val_jac)
        if logs is not None:
            logs.flush()

    if ckpt is not None:
        ckpt.save(final_ckpt_name(i), model)
    return state, history


def test_model(
    model,
    images,
    masks,
    tsind,
    batch_size,
    lim,
    logs: Optional[RunLogs],
    ckpt: Optional[Checkpointer],
    i: int = 0,
):
    """F7_TEST2.py:38-184 equivalent: restore ``Finaliremmodel{i}`` into
    ``model``, evaluate the test fold, write testFile, testaccFile and the
    FPS, return (loss, jaccard, fps, first batch's outputs)."""
    device = next(model.parameters()).device
    if ckpt is not None and ckpt.exists(final_ckpt_name(i)):
        model.load_state_dict(ckpt.restore(final_ckpt_name(i)), strict=True)
    start = time.time()
    test_loss, test_jac, first_outputs = _run_eval(
        model, images, masks, tsind, batch_size, lim, device
    )
    elapsed = time.time() - start
    fps = len(tsind) / elapsed if elapsed > 0 else 0.0
    if logs is not None:
        logs.test.write(str(test_loss) + "\n")
        logs.testacc.write(str(test_jac) + "\n")
        if ckpt is not None:
            with open(ckpt.run_dir / "fpsfile.txt", "w") as f:
                f.write(str(fps) + "\n")
    print("Test Jaccard:", test_jac, "FPS:", fps)
    return test_loss, test_jac, fps, first_outputs
