"""One experiment from config to summary, the F2_MAIN.py equivalent.

Counterpart of ``corrifnet_tpu/run/main.py``. Flow (F2_MAIN.py:45-313):
read the config -> CrossVal fold split -> load and normalize the data ->
build the model by ``modeltype`` (warm-started from ``transfer_checkpoint``
with ``transfertype='yestr'``) -> Adam or SGD under the epoch-start StepLR
-> a dated run directory with the log files -> train (per-epoch checkpoint
and validation) -> test with FPS (+ the segplot family of the first test
image) -> a dated human-readable summary -> the learning and accuracy
curve PNGs.

    python -m corrifnet_tpu_torch.run.main --config experiments/model0.txt \\
        [--run-root experiments] [--index 0 | --indices 0,1,2] \\
        [--resume RUN_DIR] [--train-deadline-s SECONDS] \\
        [--synthetic-seed 0] [--device cuda]

With ``--indices`` the config path may hold ``{i}`` (the reference's
``model{i}.txt`` loop, F2_MAIN.py:60-62). ``--resume`` continues a run
started with ``extended_checkpoints=true`` from its ``state{i}``
checkpoint; ``--train-deadline-s`` stops training at the first epoch
boundary past that many seconds and still tests. On a GPU the data set is
kept on the card where it fits (``_maybe_device_dataset``:
``CORRIFNET_DEVICE_DATA``, ``CORRIFNET_DEVICE_DATA_BUDGET_GB``), and
batches of a bf16 model are copied as bf16 images and uint8 masks
(``CORRIFNET_WIRE_CAST``), as in the JAX package.

Runs on the GPU unless ``--device cpu`` is given; without a GPU the default
raises, it never falls back to the CPU. The curve PNGs need matplotlib:
without it one printed line names the files that were not written (the
segplot PNGs have their own writer). Still to be ported (see ROADMAP.md):
the config fields ``config.check_supported`` names.
``pallas_fused_blocks`` is honoured: it runs the encoder bottlenecks through
the fused convolution kernels; so is ``decoder_lean`` (None: the lean decoder
backward at batch <= 4, as the JAX package).

A run repeats its bits on every device, as the JAX package's does: it runs
under ``utils.determinism.deterministic()`` (PyTorch's deterministic
algorithms, cuDNN's deterministic algorithms without benchmarking), which
raises at any op without a deterministic implementation, and the caller's
settings come back when it returns.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time
from pathlib import Path

import numpy as np
import torch

from corrifnet_tpu_torch.config import ExperimentConfig, check_supported, load_config
from corrifnet_tpu_torch.data import cross_val, load_dstl
from corrifnet_tpu_torch.data.dataset import DeviceDataset
from corrifnet_tpu_torch.models import create_model
from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
from corrifnet_tpu_torch.run.evaluate import compute_dtype, load_weights
from corrifnet_tpu_torch.run.segplot import segplot
from corrifnet_tpu_torch.train import (
    Checkpointer,
    init_state,
    test_model,
    train_model,
)
from corrifnet_tpu_torch.train.loop import _wire_cast_enabled
from corrifnet_tpu_torch.utils.determinism import deterministic
from corrifnet_tpu_torch.utils.logfiles import RunLogs

__all__ = ["run_experiment", "main"]

_CURVES = {"train_loss": "trainFile.txt", "train_jac": "trainaccFile.txt",
           "val_loss": "valFile.txt", "val_jac": "valaccFile.txt"}


@deterministic()
def run_experiment(cfg: ExperimentConfig, run_root=".", index: int = 0,
                   device="cuda", resume_dir=None, deadline_s=None):
    """One experiment (F2_MAIN.py:45-313) on ``device``.

    With ``resume_dir`` (a run directory trained with
    ``extended_checkpoints=true``) training continues from its
    ``state{index}`` checkpoint: weights, optimizer state and step
    restored, the log files cut back to the last whole epoch and appended
    to, so that the run ends as an uninterrupted one would. ``deadline_s``
    bounds the training's wall clock: past it, training stops at the next
    epoch boundary (logged, and resumable with extended checkpoints) and
    the test runs on the model reached."""
    begin = datetime.datetime.now()
    device = torch.device(device)
    print("device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    check_supported(cfg, device)
    deadline = time.monotonic() + float(deadline_s) if deadline_s else None

    tsind, trind, vlind = cross_val(cfg.train_set_size, cfg.fno, cfg.fsiz)
    data = load_dstl(cfg.train_set_size, trind, pack_path=cfg.data_pack,
                     synthetic_seed=cfg.synthetic_seed,
                     data_dirs=cfg.data_dirs)

    # transfertype (F2_MAIN.py:134-165): 'notr' re-initializes the 2-D conv
    # kernels the JAX package does with cfg.initialization (of the ported
    # models, RobustMseg's 54 outside its per-modality encoders), from a
    # stream of its own; 'yestr' warm-starts from cfg.transfer_checkpoint,
    # converted as cfg.modeltype (the model stays as built when none is named,
    # as in the JAX package); 'loratr' leaves the model as built
    model = create_model(cfg.modeltype, dtype=compute_dtype(cfg), device=device,
                         seed=cfg.seed,
                         pallas_fused_blocks=cfg.pallas_fused_blocks,
                         decoder_lean=cfg.decoder_lean)
    if cfg.transfertype == "notr":
        apply_reference_init_scheme(model, cfg.initialization, scheme_generator(cfg.seed))
    elif cfg.transfertype == "yestr" and cfg.transfer_checkpoint:
        model.load_state_dict(load_weights(cfg.transfer_checkpoint, cfg.modeltype),
                              strict=True)
    state = init_state(model, cfg.optimizer_type)

    start_epoch, prior_history = 0, None
    if resume_dir is not None:
        run_dir = Path(resume_dir)
        ckpt = Checkpointer(run_dir)
        state_name = f"state{index}"
        if not ckpt.exists(state_name):
            raise FileNotFoundError(
                f"{run_dir / state_name}: no extended checkpoint to resume "
                "from — start the run with extended_checkpoints=true"
            )
        ckpt.restore_state(state_name, state)
        steps_per_epoch = -(-len(trind) // cfg.mini_batch_size)
        start_epoch, rem = divmod(state.step, steps_per_epoch)
        if rem or start_epoch == 0:
            raise ValueError(
                f"{run_dir / state_name}: step {state.step} is not a whole "
                f"number of epochs ({steps_per_epoch} steps/epoch) — was the "
                "checkpoint written by this config?"
            )
        logs = RunLogs.open_resumed(run_dir, start_epoch)
        prior_history = {k: _read_curve(run_dir / f) for k, f in _CURVES.items()}
        print(f"resuming {run_dir} at epoch {start_epoch}/{cfg.n_epochs}")
    else:
        d = datetime.datetime.now()
        run_dir = Path(run_root) / (
            f"{d.year}_{d.month}_{d.day}_{d.hour}_{d.minute}_model{index}"
        )
        run_dir.mkdir(parents=True, exist_ok=True)
        logs = RunLogs.open(run_dir)
        ckpt = Checkpointer(run_dir)

    device_data = _maybe_device_dataset(model, data.images, data.masks, vlind,
                                        tsind, device)
    try:
        state, history = train_model(
            state,
            n_epochs=cfg.n_epochs, learn_rate=cfg.learn_rate,
            step_size=cfg.step_size, gamma=cfg.gamma,
            images=data.images, masks=data.masks, trind=trind, vlind=vlind,
            batch_size=cfg.mini_batch_size, lim=cfg.lim,
            logs=logs, ckpt=ckpt, i=index, seed=cfg.seed,
            val_from_checkpoint=cfg.val_from_checkpoint,
            start_epoch=start_epoch,
            # a resumed run stays resumable whatever the flag says
            extended_checkpoints=cfg.extended_checkpoints or resume_dir is not None,
            deadline=deadline,
            device_data=device_data,
        )
        if prior_history is not None:
            history.update({k: v + history[k] for k, v in prior_history.items()})
        test_loss, test_jac, fps, first_outputs = test_model(
            model, data.images, data.masks, tsind, cfg.mini_batch_size, cfg.lim,
            logs, ckpt, i=index, device_data=device_data,
        )
        # first-test-image overlay (F7_TEST2.py:136-166)
        first = tsind[0]
        segplot(run_dir, cfg.lim, np.moveaxis(data.images[first, 0], 0, -1),
                first_outputs[0, 0, 0], data.masks[first, 0, 0],
                data.tr_mean_r, data.tr_mean_g, data.tr_mean_b)
    finally:
        logs.close()
    _write_summary_log(run_dir, cfg, begin, trind, vlind, test_jac, model)
    _write_curves(run_dir, history)

    if device.type == "cuda":
        # device-memory telemetry (F2_MAIN.py:306-309)
        print(f"Memory allocated after model {index}",
              torch.cuda.memory_allocated(device))
    return {
        "run_dir": str(run_dir),
        "test_loss": test_loss,
        "test_jaccard": test_jac,
        "fps": fps,
        "history": history,
        "train_steps": state.step,
        "resident_bytes": 0 if device_data is None else device_data.nbytes,
    }


def scheme_generator(seed: int) -> torch.Generator:
    """The generator of the ``notr`` re-initialization: a stream of its own,
    made from the config's seed and independent of the weights' own."""
    state = np.random.SeedSequence([int(seed), 1]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _maybe_device_dataset(model, images, masks, vlind, tsind, device):
    """A ``DeviceDataset`` of what fits on ``device``, or None to stream.

    The choices are the JAX package's (``corrifnet_tpu/run/main.py``
    ``_maybe_device_dataset``), under its variables, so that one
    environment places the same data in both: by default on a CUDA device
    and never on the CPU; ``CORRIFNET_DEVICE_DATA=0`` turns it off and
    ``=1`` forces the whole set (on any device). The auto choice keeps the
    whole set where ``DeviceDataset.fits_bytes`` admits it
    (``CORRIFNET_DEVICE_DATA_BUDGET_GB``, default 5), else the validation
    and test folds (evaluated every epoch and in the timed test), else the
    validation fold, else nothing. Prints one line naming what is resident
    and its size."""
    choice = _resident_choice(model, images, masks, vlind, tsind, device)
    if choice is None:
        return None
    indices, what = choice
    dd = DeviceDataset(images, masks, wire_cast=_wire_cast_enabled(model),
                       indices=indices, device=device)
    print(f"device-resident {what}: {dd.nbytes / 1e9:.2f} GB on {device}")
    return dd


def _resident_choice(model, images, masks, vlind, tsind, device):
    """``_maybe_device_dataset``'s choice without the copy: None, or
    (indices, what), with indices None for the whole set."""
    mode = os.environ.get("CORRIFNET_DEVICE_DATA", "auto")
    if mode == "0":
        return None
    if mode == "1":
        return None, "dataset"
    if torch.device(device).type != "cuda":
        return None
    wire = _wire_cast_enabled(model)
    mc = wire and DeviceDataset._masks_compressible(masks)
    if DeviceDataset.fits_bytes(images.nbytes, masks.nbytes, wire,
                                mask_compressible=mc):
        return None, "dataset"
    # byte arithmetic only: images[subset] would copy gigabytes on the host
    n_val, n_test = len(vlind), len(tsind)
    candidates = []
    if n_val and n_test:
        candidates.append((np.concatenate([np.asarray(vlind), np.asarray(tsind)]),
                           "val+test-fold"))
    if n_val:
        candidates.append((np.asarray(vlind), "val-fold"))
    for cand, label in candidates:
        frac = len(cand) / len(images)
        if DeviceDataset.fits_bytes(int(images.nbytes * frac), int(masks.nbytes * frac),
                                    wire, mask_compressible=mc):
            return cand, label
    return None


def _read_curve(path):
    """A one-float-per-line log file as a list (the curves of a resumed run)."""
    if not Path(path).exists():
        return []
    return [float(ln) for ln in Path(path).read_text().split()]


def _write_summary_log(run_dir, cfg, begin, trind, vlind, test_jac, model):
    """Dated human-readable summary (F2_MAIN.py:258-287)."""
    a = datetime.datetime.now()
    path = Path(run_dir) / f"{a.year}_{a.month}_{a.day}_{a.hour}_{a.minute}.txt"
    with open(path, "w") as f:
        f.write("Date:" + str(datetime.date.today()) + "\n")
        f.write(f"Ending Time:{a.hour}:{a.minute}\n")
        f.write(f"Starting Time:{begin.hour}:{begin.minute}\n")
        f.write("Data set size:" + str(cfg.train_set_size) + "\n")
        f.write("Fold number:" + str(cfg.fno) + "\n")
        f.write("Fold number:" + str(cfg.fsiz) + "\n")
        f.write("Number of validation images:" + str(len(vlind)) + "\n")
        f.write("Number of training images:" + str(len(trind)) + "\n")
        f.write("Mini batch size:" + str(cfg.mini_batch_size) + "\n")
        f.write("Type of initialization:" + cfg.initialization + "\n")
        f.write("Test accuracy:" + str([test_jac]) + "\n")
        f.write("Learning rate:" + str(cfg.learn_rate) + "\n")
        f.write("Model version:" + str(cfg.modeltype) + "\n")
        f.write("Optimizer type:" + cfg.optimizer_type + "\n")
        f.write("Total number of epochs:" + str(cfg.n_epochs) + "\n")
        f.write("Training loss function:" + str(cfg.trainloss) + "\n")
        f.write("Validation loss function:" + str(cfg.validationloss) + "\n")
        f.write("Accuracy function:" + str(cfg.accuracy) + "\n")
        f.write("Channel index:" + str(cfg.chindex) + "\n")
        f.write("Transfer:" + str(cfg.transfertype) + "\n")
        f.write("Model Summary:\n" + repr(model) + "\n")


_CURVE_FILES = ("learning_curves.png", "accuracy_curves.png")


def _write_curves(run_dir, history):
    """Learning and accuracy curve PNGs (F2_MAIN.py:290-304); without
    matplotlib, one line naming the files not written."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is not installed: not written:", ", ".join(_CURVE_FILES))
        return
    plt.figure()
    plt.plot(history["train_loss"], "k-", label="Train Loss")
    plt.plot(history["val_loss"], "r--", label="Validation Loss")
    plt.title("Learning Curves")
    plt.legend(loc="upper left")
    plt.savefig(Path(run_dir) / _CURVE_FILES[0])
    plt.close()
    plt.figure()
    plt.plot(history["train_jac"], "k-", label="Train Accuracy")
    plt.plot(history["val_jac"], "r--", label="Validation Accuracy")
    plt.title("Accuracy Curves")
    plt.legend(loc="upper left", bbox_to_anchor=(1, 1))
    plt.savefig(Path(run_dir) / _CURVE_FILES[1], bbox_inches="tight")
    plt.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True,
                    help="18-line .txt or .json config; with --indices it may hold "
                         "{i} (the reference's model{i}.txt loop)")
    ap.add_argument("--run-root", default=".")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--indices", default=None,
                    help="comma-separated experiment indices, e.g. 0,1,2")
    ap.add_argument("--synthetic-seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resume", default=None, metavar="RUN_DIR",
                    help="continue an interrupted run in place from its state{i} "
                         "checkpoint (a run started with extended_checkpoints=true)")
    ap.add_argument("--train-deadline-s", type=float, default=None,
                    help="wall-clock budget of the training: past it, stop at the "
                         "next epoch boundary (logged, resumable) and test")
    args = ap.parse_args(argv)
    if args.resume and args.indices:
        ap.error("--resume takes a single run directory; use --index")

    indices = ([int(i) for i in args.indices.split(",")] if args.indices
               else [args.index])
    results = {}
    for i in indices:
        cfg = load_config(args.config.format(i=i) if "{i}" in args.config
                          else args.config)
        if args.synthetic_seed is not None:
            cfg.synthetic_seed = args.synthetic_seed
        result = run_experiment(cfg, args.run_root, i, device=args.device,
                                resume_dir=args.resume,
                                deadline_s=args.train_deadline_s)
        print(f"[model{i}] test jaccard:", result["test_jaccard"],
              "fps:", result["fps"])
        results[i] = result
    return results if args.indices else results[indices[0]]


if __name__ == "__main__":
    main()
