"""Import trained weights into a run directory of the port.

Counterpart of ``corrifnet_tpu/run/import_checkpoint.py``. The reference
trains with torch and saves ``model.state_dict()`` as
``Finaliremmodel{i}.pt`` (F4_TRAIN.py:84-86). The port keeps the
reference's key layout, so such a file needs no conversion:
``run.evaluate.load_weights`` drops what the reference holds and the port
does not (BatchNorm's step counters, UNetV2's dead up-sampling weights,
ENet's dead ``project_layer``). It also reads a flattened JAX ``.npz``,
which ``scripts/export_jax_checkpoint.py`` writes from a JAX run directory.
Every key and shape is held against the model's own ``state_dict``, built
on the ``meta`` device, before anything is written; the file is then
written by the port's ``Checkpointer``, where ``run.evaluate --run-dir``
and the training loop's test restore read it:

    python -m corrifnet_tpu_torch.run.import_checkpoint MMVit4 \\
        /path/Finaliremmodel0.pt /path/run_dir [--name Finaliremmodel0]
"""

from __future__ import annotations

import argparse
import sys

import torch

from corrifnet_tpu_torch.models.registry import available_models, get_spec
from corrifnet_tpu_torch.run.evaluate import load_weights
from corrifnet_tpu_torch.train.checkpoint import Checkpointer

__all__ = ["import_checkpoint", "main"]

_LISTED = 8  # keys listed of each kind of mismatch


def expected_shapes(modeltype: str) -> dict:
    """{key: shape} of ``modeltype``'s ``state_dict``, built on the ``meta``
    device (no memory, no initialization)."""
    with torch.device("meta"):
        model = get_spec(modeltype).factory(dtype=torch.float32, transformer_dropout=0.0)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def validate(modeltype: str, state_dict, path) -> None:
    """``ValueError`` listing the missing, unexpected and shape-mismatched
    keys of ``state_dict`` against ``modeltype``'s, at most eight of each."""
    want = expected_shapes(modeltype)
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    found = {
        "missing": sorted(set(want) - set(got)),
        "unexpected": sorted(set(got) - set(want)),
        "shape-mismatch": sorted(k for k in set(want) & set(got) if want[k] != got[k]),
    }
    if not any(found.values()):
        return
    lines = [f"{path} does not match {modeltype}'s state_dict:"]
    for label, keys in found.items():
        for k in keys[:_LISTED]:
            lines.append(f"  {label}: {k}" + (f" {got[k]}, want {want[k]}"
                                              if label == "shape-mismatch" else ""))
        if len(keys) > _LISTED:
            lines.append(f"  ... and {len(keys) - _LISTED} more {label}")
    raise ValueError("\n".join(lines))


def import_checkpoint(modeltype: str, input_path, run_dir,
                      name: str = "Finaliremmodel0") -> str:
    """Write ``input_path`` (a reference or port ``.pt`` ``state_dict``, or
    a flattened JAX ``.npz``, of ``modeltype``) into ``run_dir/name`` as a
    port checkpoint, once its keys and shapes are ``modeltype``'s. An
    unknown model raises ``KeyError`` listing the known ones; another
    model's weights raise ``ValueError`` naming both. Returns the path."""
    if modeltype not in available_models():
        raise KeyError(f"no model {modeltype!r} in the port; available: {available_models()}")
    state_dict = load_weights(input_path, modeltype)
    validate(modeltype, state_dict, input_path)
    return str(Checkpointer(run_dir).save(name, state_dict))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="corrifnet_tpu_torch.run.import_checkpoint",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("modeltype", help="registry model id, e.g. MMVit4")
    ap.add_argument("input", help="reference .pt state_dict, or a JAX .npz")
    ap.add_argument("run_dir", help="output directory (a run directory of the port)")
    ap.add_argument("--name", default="Finaliremmodel0",
                    help="checkpoint name (default: Finaliremmodel0)")
    args = ap.parse_args(argv)
    path = import_checkpoint(args.modeltype, args.input, args.run_dir, args.name)
    print(f"imported {args.input} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
