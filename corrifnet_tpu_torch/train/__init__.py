"""Training of the port (counterpart of ``corrifnet_tpu.train``)."""

from corrifnet_tpu_torch.train.checkpoint import (
    Checkpointer,
    epoch_ckpt_name,
    final_ckpt_name,
)
from corrifnet_tpu_torch.train.loop import (
    epoch_dropout_seed,
    test_model,
    train_model,
    validate,
)
from corrifnet_tpu_torch.train.schedule import step_lr, step_lr_reported
from corrifnet_tpu_torch.train.state import (
    TrainState,
    init_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    masked_loss_and_jaccard,
)

__all__ = [
    "Checkpointer",
    "TrainState",
    "epoch_ckpt_name",
    "epoch_dropout_seed",
    "final_ckpt_name",
    "init_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "masked_loss_and_jaccard",
    "step_lr",
    "step_lr_reported",
    "test_model",
    "train_model",
    "validate",
]
