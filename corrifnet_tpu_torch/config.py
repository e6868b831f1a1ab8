"""Experiment configuration (reference: the 18-line positional text file
read at F2_MAIN.py:62-83).

Counterpart of ``corrifnet_tpu/config.py``, kept as the port's own copy:
every field and default is the JAX package's, so the same 18-line ``.txt``
and the same JSON load in both. Only the ``jax_dtype`` property is gone
(``run.evaluate.compute_dtype`` names the torch dtype). ``check_supported``,
called by both entry points before anything is built, refuses by name every
field that is set off its default, changes what is computed or written, and
is not honoured by the port yet; fields that steer TPU machinery with no
effect on results are accepted and named on one log line.

Two loaders: the reference's positional ``model{i}.txt`` format (one value
per line, order fixed) for drop-in compatibility, and a modern JSON/dict
loader. Fields and defaults mirror the reference config exactly; extra
TPU-framework knobs (dtype, sharding, decoder depth mode, pallas toggle)
have parity-neutral defaults.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

__all__ = ["ExperimentConfig", "check_supported", "load_text_config",
           "load_config"]


@dataclasses.dataclass
class ExperimentConfig:
    # --- the 18 reference lines, in file order (F2_MAIN.py:66-83) ---
    train_set_size: int = 5985
    fno: int = 2              # 1-based fold number (committed run used fold 2)
    fsiz: int = 5
    val_ratio: float = 0.1    # parsed but ignored; CrossVal hard-codes 0.1
    mini_batch_size: int = 4
    n_epochs: int = 70
    learn_rate: float = 1e-4
    optimizer_type: str = "Adam"        # 'Adam' | 'SGD'
    trainloss: str = "BCEWithLogitsLoss"
    validationloss: str = "BCEWithLogitsLoss"
    accuracy: str = "Jaccard"
    initialization: str = "kaiming_normal_"
    step_size: int = 5
    gamma: float = 0.9
    lim: int = 224
    modeltype: str = "MMVit4"
    chindex: str = "0"
    transfertype: str = "notr"          # 'yestr' | 'notr' | 'loratr'

    # --- TPU-framework extensions (not in the reference file) ---
    dtype: str = "bfloat16"             # compute dtype ('float32' for parity)
    use_pallas: bool = True
    depth_mode: str = "full"            # MMVit4 decoder: 'full' | 'pruned'
    val_from_checkpoint: bool = True
    data_pack: Optional[str] = None     # .npz pack path
    data_dirs: Optional[dict] = None    # {'rgb':…, 'all20':…, 'mask':…}
    synthetic_seed: Optional[int] = None
    seed: int = 0
    transfer_checkpoint: Optional[str] = None  # warm start (transfertype=yestr)
    mesh_shape: Optional[list] = None   # [data, model] for SPMD training
    chain_steps: int = 1   # optimizer steps per device dispatch (single-
                           # device only: ignored, with a warning, if
                           # mesh_shape is also set)
    fuse_expand_bn: bool = False  # MMVit4: fold bn3/down_bn into their
                                  # convs (nn/fusedbn.py)
    pallas_fused_blocks: bool = False  # MMVit4: bottleneck convs via the
                                  # fused Pallas kernels (ops/fusedconv.py)
    remat_mode: str = "all"  # MMVit4 encoder remat: 'all' | 'mid' | 'early'
                             # | 'none' | 'mid1' (stage-1-scoped 'mid';
                             # models/resnet3d.py, models/mmvit4.py)
    decoder_remat: bool = False  # MMVit4: rematerialize decoder conv blocks
                             # in the backward — bit-identical; shrinks the
                             # full-depth multi-GB bwd working set
    decoder_lean: "bool | None" = None  # MMVit4: lean-residual decoder
                             # backward (nn/leandec.py) — bit-identical
                             # forward; None = batch-adaptive (on at
                             # batch <= 4, the regime where its memory
                             # cut admits device-resident data)
    decoder_chunk: int = 0   # MMVit4 lean mode: depth-chunk the level-1
                             # conv backwards (memory-only lever,
                             # measured +94 ms B=8 device step; NOTES r5)
    scan_unroll: int = 1     # MMVit4 encoder tail-scan unroll; 0 = full
                             # unroll (smaller device time, bigger program)
    auto_layout: bool = False  # XLA-chosen train-state layouts. OPT-IN:
                              # on the CLI's TPU path (rbg keys) the
                              # executable fails its layout canary and
                              # falls back anyway (observed r3 + r4), and
                              # the measured win on canary-passing
                              # programs is ~2-3%, backend-mood-dependent
                              # (NOTES round-4) — not worth carrying the
                              # state-swap machinery on the user path by
                              # default. Single-device only — ignored
                              # when mesh_shape is set.
    extended_checkpoints: bool = False  # also save the FULL TrainState
                              # (params + optimizer moments + step) each
                              # epoch as state{i} — enables true
                              # mid-training resume via run.main --resume
                              # (capability the reference lacks: it only
                              # saves weights, F4_TRAIN.py:84)



_TEXT_FIELDS = [
    ("train_set_size", int), ("fno", int), ("fsiz", int), ("val_ratio", float),
    ("mini_batch_size", int), ("n_epochs", int), ("learn_rate", float),
    ("optimizer_type", str), ("trainloss", str), ("validationloss", str),
    ("accuracy", str), ("initialization", str), ("step_size", int),
    ("gamma", float), ("lim", int), ("modeltype", str), ("chindex", str),
    ("transfertype", str),
]


def load_text_config(path) -> ExperimentConfig:
    """Parse the reference's 18-line positional format (F2_MAIN.py:62-83)."""
    lines = [ln.rstrip() for ln in Path(path).read_text().splitlines()]
    if len(lines) < len(_TEXT_FIELDS):
        raise ValueError(
            f"{path}: expected {len(_TEXT_FIELDS)} config lines, got {len(lines)}"
        )
    kwargs = {
        name: conv(lines[idx]) for idx, (name, conv) in enumerate(_TEXT_FIELDS)
    }
    return ExperimentConfig(**kwargs)


def load_config(path) -> ExperimentConfig:
    """Load either format by extension (.json or reference .txt)."""
    p = Path(path)
    if p.suffix == ".json":
        return ExperimentConfig(**json.loads(p.read_text()))
    return load_text_config(p)


# field: (is it off its default?, what it asks for)
_NOT_HONOURED = {
    "mesh_shape": (lambda v: v is not None, "SPMD training over a device mesh"),
}
# TPU machinery without effect on what is computed or written (remat_mode,
# which changes no bit either, is honoured: run.main gives it to MMVit4)
_NO_EFFECT = {"chain_steps": 1, "auto_layout": False, "scan_unroll": 1}


def check_supported(cfg: ExperimentConfig, device) -> None:
    """Raise ``NotImplementedError`` naming the first config field that is
    set off its default and that the port does not honour yet; the JAX entry
    point honours each (``corrifnet_tpu/run/main.py:48-67``). ``use_pallas =
    False`` is refused on a CUDA device only: there the kernels are the only
    path, on the CPU the plain versions run either way."""
    for name, (is_set, what) in _NOT_HONOURED.items():
        if is_set(getattr(cfg, name)):
            raise NotImplementedError(
                f"config field {name}={getattr(cfg, name)!r} ({what}) is not "
                f"ported to corrifnet_tpu_torch yet (see ROADMAP.md)")
    if cfg.use_pallas is False and str(device).startswith("cuda"):
        raise NotImplementedError(
            "config field use_pallas=False (the plain versions in place of the "
            "kernels) is not ported to corrifnet_tpu_torch on a CUDA device "
            "(see ROADMAP.md)")
    inert = [f"{k}={getattr(cfg, k)!r}" for k, v in _NO_EFFECT.items()
             if getattr(cfg, k) != v]
    if inert:
        print("config: " + ", ".join(inert) + " steer TPU machinery and have no "
              "effect in corrifnet_tpu_torch")
