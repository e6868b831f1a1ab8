"""One experiment from config to summary, the F2_MAIN.py equivalent.

Counterpart of ``corrifnet_tpu/run/main.py``. Flow (F2_MAIN.py:45-313):
read the config -> CrossVal fold split -> load and normalize the data ->
build the model by ``modeltype`` -> Adam or SGD under the epoch-start StepLR
-> a dated run directory with the log files -> train (per-epoch checkpoint
and validation) -> test with FPS (+ the segplot family of the first test
image) -> a dated human-readable summary -> the learning and accuracy
curve PNGs.

    python -m corrifnet_tpu_torch.run.main --config experiments/model0.txt \\
        [--run-root experiments] [--index 0] [--synthetic-seed 0] [--device cuda]

Runs on the GPU unless ``--device cpu`` is given; without a GPU the default
raises, it never falls back to the CPU. The curve PNGs need matplotlib:
without it one printed line names the files that were not written (the
segplot PNGs have their own writer). Still to be ported (see ROADMAP.md),
and refused by the CLI when asked for: ``--resume``, ``--train-deadline-s``,
``--indices`` and ``transfertype`` warm starts; and the config fields
``config.check_supported`` names.
``pallas_fused_blocks`` is honoured: it runs the encoder bottlenecks through
the fused convolution kernels; so is ``decoder_lean`` (None: the lean decoder
backward at batch <= 4, as the JAX package).
"""

from __future__ import annotations

import argparse
import datetime
from pathlib import Path

import numpy as np
import torch

from corrifnet_tpu_torch.config import ExperimentConfig, check_supported, load_config
from corrifnet_tpu_torch.data import cross_val, load_dstl
from corrifnet_tpu_torch.models import create_model
from corrifnet_tpu_torch.run.evaluate import compute_dtype
from corrifnet_tpu_torch.run.segplot import segplot
from corrifnet_tpu_torch.train import (
    Checkpointer,
    init_state,
    test_model,
    train_model,
)
from corrifnet_tpu_torch.utils.logfiles import RunLogs

__all__ = ["run_experiment", "main"]

_NOT_PORTED = "is not ported to corrifnet_tpu_torch yet (see ROADMAP.md)"


def run_experiment(cfg: ExperimentConfig, run_root=".", index: int = 0,
                   device="cuda"):
    """One experiment (F2_MAIN.py:45-313) on ``device``."""
    begin = datetime.datetime.now()
    device = torch.device(device)
    print("device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    if cfg.transfertype == "yestr":
        raise NotImplementedError(f"transfertype 'yestr' (warm start) {_NOT_PORTED}")
    check_supported(cfg, device)

    tsind, trind, vlind = cross_val(cfg.train_set_size, cfg.fno, cfg.fsiz)
    data = load_dstl(cfg.train_set_size, trind, pack_path=cfg.data_pack,
                     synthetic_seed=cfg.synthetic_seed,
                     data_dirs=cfg.data_dirs)

    # transfertype 'notr' re-initializes the 2-D convs with cfg.initialization
    # (F2_MAIN.py:134-157); MMVit4 has none, so its own initialization stands
    model = create_model(cfg.modeltype, dtype=compute_dtype(cfg), device=device,
                         seed=cfg.seed,
                         pallas_fused_blocks=cfg.pallas_fused_blocks,
                         decoder_lean=cfg.decoder_lean)
    state = init_state(model, cfg.optimizer_type)

    d = datetime.datetime.now()
    run_dir = Path(run_root) / (
        f"{d.year}_{d.month}_{d.day}_{d.hour}_{d.minute}_model{index}"
    )
    run_dir.mkdir(parents=True, exist_ok=True)
    logs = RunLogs.open(run_dir)
    ckpt = Checkpointer(run_dir)
    try:
        state, history = train_model(
            state,
            n_epochs=cfg.n_epochs, learn_rate=cfg.learn_rate,
            step_size=cfg.step_size, gamma=cfg.gamma,
            images=data.images, masks=data.masks, trind=trind, vlind=vlind,
            batch_size=cfg.mini_batch_size, lim=cfg.lim,
            logs=logs, ckpt=ckpt, i=index, seed=cfg.seed,
            val_from_checkpoint=cfg.val_from_checkpoint,
        )
        test_loss, test_jac, fps, first_outputs = test_model(
            model, data.images, data.masks, tsind, cfg.mini_batch_size, cfg.lim,
            logs, ckpt, i=index,
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
    }


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
    ap.add_argument("--config", required=True, help="18-line .txt or .json config")
    ap.add_argument("--run-root", default=".")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--synthetic-seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--indices", default=None, help="(not ported yet)")
    ap.add_argument("--resume", default=None, metavar="RUN_DIR",
                    help="(not ported yet)")
    ap.add_argument("--train-deadline-s", type=float, default=None,
                    help="(not ported yet)")
    args = ap.parse_args(argv)
    for flag in ("indices", "resume", "train_deadline_s"):
        if getattr(args, flag) is not None:
            ap.error(f"--{flag.replace('_', '-')} {_NOT_PORTED}")

    cfg = load_config(args.config)
    if args.synthetic_seed is not None:
        cfg.synthetic_seed = args.synthetic_seed
    result = run_experiment(cfg, args.run_root, args.index, device=args.device)
    print(f"[model{args.index}] test jaccard:", result["test_jaccard"],
          "fps:", result["fps"])
    return result


if __name__ == "__main__":
    main()
