#!/usr/bin/env python3
"""Export a JAX run's orbax checkpoint as the ``.npz`` the PyTorch port reads.

A run of the JAX package (``corrifnet_tpu.run.main``) saves
``Finaliremmodel{i}`` as an orbax checkpoint directory, which the port does
not read (it imports no orbax). This script restores it as the JAX
package's ``evaluate_run`` does (``corrifnet_tpu/run/evaluate.py:102-110``:
``create_model``, ``init_state`` for the template, ``Checkpointer.restore``)
and writes its ``params`` and ``batch_stats`` as one ``.npz`` of
``/``-joined flat keys (``params/encoders/conv6/kernel``, ...), the layout
of ``corrifnet_tpu_torch.models.jax_import.unflatten_variables``. Run it
where jax, flax and orbax are installed (the JAX package's machine, on the
CPU is enough), then take the file to the port:

    JAX_PLATFORMS=cpu python scripts/export_jax_checkpoint.py \\
        --config model0.txt --run-dir RUN --index 0 --out w.npz
    python -m corrifnet_tpu_torch.run.import_checkpoint MMVit4 w.npz PORT_RUN
    python -m corrifnet_tpu_torch.run.evaluate --config model0.txt --run-dir PORT_RUN

(or ``run.evaluate --weights w.npz``; ``transfer_checkpoint`` reads it too).
"""

from __future__ import annotations

import argparse
import sys
from collections.abc import Mapping
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

__all__ = ["export", "flatten", "main"]


def flatten(tree, prefix=""):
    """Nested mapping -> {'a/b/c': numpy array}."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten(value, name))
        else:
            flat[name] = np.asarray(value)
    return flat


def export(config, run_dir, index, out):
    """Write ``Finaliremmodel{index}`` of the JAX run ``run_dir`` (built by
    ``config``'s ``modeltype`` and ``dtype``) to ``out``; returns the number
    of arrays written."""
    import jax

    from corrifnet_tpu.config import load_config
    from corrifnet_tpu.data.dstl import LIM
    from corrifnet_tpu.models import create_model, get_spec
    from corrifnet_tpu.train import Checkpointer, final_ckpt_name, init_state, make_optimizer

    cfg = load_config(config)
    model = create_model(cfg.modeltype, dtype=cfg.jax_dtype)
    shape = (1, 3, 3, LIM, LIM) if get_spec(cfg.modeltype).input_kind == "5d" else (1, 3, LIM, LIM)
    state = init_state(model, jax.random.PRNGKey(0), np.zeros(shape, np.float32),
                       make_optimizer("Adam"))
    ckpt = Checkpointer(run_dir)
    try:
        params, batch_stats = ckpt.restore(
            final_ckpt_name(index), {"params": state.params, "batch_stats": state.batch_stats})
    finally:
        ckpt.close()
    flat = flatten({"params": params, "batch_stats": batch_stats})
    np.savez(out, **flat)
    return len(flat)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="the run's config (.txt or .json)")
    ap.add_argument("--run-dir", required=True, help="the JAX run directory")
    ap.add_argument("--index", type=int, default=0, help="Finaliremmodel{index} (default 0)")
    ap.add_argument("--out", required=True, help="the .npz to write")
    args = ap.parse_args(argv)
    n = export(args.config, args.run_dir, args.index, args.out)
    print(f"exported {n} arrays of {Path(args.run_dir) / f'Finaliremmodel{args.index}'} "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
