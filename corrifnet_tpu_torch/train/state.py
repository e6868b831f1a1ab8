"""Train state and the train and eval steps (reference: F4_TRAIN.py:39-208).

Counterpart of ``corrifnet_tpu/train/state.py:45-89, 299-354``. Kept
semantics:

  * loss = BCE-with-logits on the model's sigmoid output (the reference's
    double sigmoid, F4_TRAIN.py:58-60), in f32 on the f32-cast output, as a
    mean over the valid samples' elements;
  * accuracy = soft Jaccard2 on the first modality channel, flattened to a
    column (F4_TRAIN.py:65-71), with padded samples masked out;
  * optimizer: PyTorch's Adam at its defaults (betas 0.9/0.999, eps 1e-8
    outside the square root, which is also ``optax.scale_by_adam``) or plain
    SGD (F2_MAIN.py:168-173); the step is given the epoch's LR
    (``train.schedule``). The reference checkpoints the weights only; with
    ``extended_checkpoints`` the whole ``TrainState`` (weights, the
    optimizer's state and the step) is also written each epoch, for
    ``run.main --resume`` (``train.checkpoint.Checkpointer.save_state``).

The JAX package's ``_AutoLayoutStep``, ``LayoutSlot`` and
``make_train_multi_step`` exist for the TPU's compiler and dispatch and
have no counterpart here: PyTorch runs eagerly and updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from corrifnet_tpu_torch.metrics.jaccard import jaccard2_masked
from corrifnet_tpu_torch.metrics.losses import bce_with_logits_per_element

__all__ = ["TrainState", "init_state", "make_eval_step", "make_optimizer",
           "make_train_step", "masked_loss_and_jaccard"]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm buffers), its optimizer and the
    number of optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        """What a resume needs, on the CPU: the model's ``state_dict``, the
        optimizer's (Adam's ``exp_avg``, ``exp_avg_sq`` and per-parameter
        ``step``) and the number of steps taken."""
        optimizer = self.optimizer.state_dict()
        optimizer["state"] = {
            i: {k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in s.items()}
            for i, s in optimizer["state"].items()
        }
        return {
            "model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "optimizer": optimizer,
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> "TrainState":
        """Restore ``state_dict()``'s output in place. The optimizer moves
        its moments to the parameters' device and keeps Adam's ``step`` a
        CPU f32 scalar, as it makes them."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        return self


def make_optimizer(kind: str, params) -> torch.optim.Optimizer:
    """Adam or SGD over ``params``; the LR is set per step (StepLR)."""
    if kind == "Adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if kind == "SGD":
        return torch.optim.SGD(params, lr=0.0)
    raise ValueError(f"unknown optimizerType {kind!r}")


def init_state(model: nn.Module, optimizer_kind: str) -> TrainState:
    return TrainState(model, make_optimizer(optimizer_kind, model.parameters()))


def masked_loss_and_jaccard(outputs, masks, valid):
    """(mean BCE over the valid samples' elements, batch Jaccard2 on channel
    0, n_valid) for f32 ``outputs`` and ``masks`` of one shape (B, ...) and
    ``valid`` (B,) in {0, 1}."""
    b = masks.shape[0]
    vmask = valid.reshape((b,) + (1,) * (masks.dim() - 1))
    per = bce_with_logits_per_element(outputs, masks)
    n_valid = valid.sum()
    loss = (per * vmask).sum() / (n_valid * (masks.numel() // b))

    # channel-0 slice before the metric (F4_TRAIN.py:68-69)
    m0 = masks[:, 0].reshape(b, -1)
    o0 = outputs[:, 0].reshape(b, -1)
    ve = valid[:, None].expand_as(m0)
    jac = jaccard2_masked(m0.reshape(-1, 1), o0.reshape(-1, 1), ve.reshape(-1, 1))[0]
    return loss, jac, n_valid


def make_train_step(state: TrainState) -> Callable:
    """Returns f(images, masks, valid, lr) -> metrics: one optimizer step on
    ``state`` in place. The metrics (loss, jaccard, n_valid) stay on the
    device as one f32 tensor of three values, so that the caller chooses
    when to wait for them."""
    model, optimizer = state.model, state.optimizer

    def step(images, masks, valid, lr):
        model.train()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        out = model(images).float()
        masks = masks.float()
        loss, jac, n_valid = masked_loss_and_jaccard(out, masks, valid)
        loss.backward()
        optimizer.step()
        state.step += 1
        return torch.stack([loss.detach(), jac.detach(), n_valid])

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """Returns f(images, masks, valid) -> (metrics, outputs) in eval mode:
    running BatchNorm statistics, no dropout, no graph."""

    @torch.no_grad()
    def step(images, masks, valid):
        model.eval()
        out = model(images).float()
        loss, jac, n_valid = masked_loss_and_jaccard(out, masks.float(), valid)
        return torch.stack([loss, jac, n_valid]), out

    return step
