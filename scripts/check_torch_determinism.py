#!/usr/bin/env python3
"""Whether the port's training step repeats its bits on one NVIDIA GPU.

    python3 scripts/check_torch_determinism.py [--models MMVit4,MMVit4+fused,...]
        [--batch 4] [--steps 2] [--probe-only]

For each model (``+fused``: built with ``pallas_fused_blocks``), at
224x224, bf16 compute, transformer dropout 0.1, Adam, random weights from
seed 0 and a random batch on the card:

1. probe: one training step under ``utils.determinism.deterministic(
   warn_only=True)``; every op that has no deterministic implementation
   warns, and the distinct warnings are printed (none is the goal);
2. repeat (unless ``--probe-only``): two copies of the model from the same
   weights, each taking ``--steps`` steps on the same batches with the same
   dropout keys under ``deterministic()``, which raises at such an op; the
   largest difference over every parameter and buffer, and over the losses,
   must be 0.

Prints the card's name and power limit first. Exits 1 when a model's
probe warned or its two runs differ, and without a GPU.
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import sys
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from corrifnet_tpu_torch.models import create_model  # noqa: E402
from corrifnet_tpu_torch.nn import DropoutRng  # noqa: E402
from corrifnet_tpu_torch.train import init_state, make_train_step  # noqa: E402
from corrifnet_tpu_torch.utils.determinism import deterministic  # noqa: E402

DEFAULT_MODELS = "MMVit4,MMVit4+fused,MMVit2,mmformer,RFNet,RobustMseg"


def build(name):
    model, _, flag = name.partition("+")
    return create_model(model, dtype=torch.bfloat16, device="cuda", seed=0,
                        pallas_fused_blocks=flag == "fused")


def batch(b, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, 3, 3, 224, 224), generator=gen, device="cuda")
    masks = (torch.rand((b, 3, 1, 224, 224), generator=gen, device="cuda") > 0.7).float()
    return x, masks, torch.ones(b, device="cuda")


def train(model, steps, b):
    """``steps`` Adam steps from dropout seed 0; the losses."""
    model.set_dropout_rng(DropoutRng(0, "cuda"))
    step = make_train_step(init_state(model, "Adam"))
    return torch.stack([step(*batch(b, i), 1e-4)[0] for i in range(steps)])


def probe(name, b):
    """The distinct messages of the ops that warned in one step."""
    model = build(name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with deterministic(warn_only=True):
            train(model, 1, b)
            torch.cuda.synchronize()
    return sorted({str(w.message).split("\n")[0] for w in caught
                   if "deterministic" in str(w.message)})


def repeat(name, steps, b):
    """(largest difference over the state, over the losses) of two runs."""
    first = build(name)
    second = copy.deepcopy(first)
    with deterministic():
        losses = [train(m, steps, b) for m in (first, second)]
        torch.cuda.synchronize()
    sa, sb = first.state_dict(), second.state_dict()
    state = max((sa[k].double() - sb[k].double()).abs().max().item() for k in sa)
    return state, (losses[0] - losses[1]).abs().max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--models", default=DEFAULT_MODELS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--probe-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_torch_determinism: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    failed = []
    for name in args.models.split(","):
        ops = probe(name, args.batch)
        print(f"{name}: {len(ops)} ops without a deterministic implementation in one "
              f"B={args.batch} step" + "".join(f"\n  {m}" for m in ops), flush=True)
        if ops:
            failed.append(name)
        if args.probe_only:
            continue
        try:
            state, losses = repeat(name, args.steps, args.batch)
        except RuntimeError as e:
            print(f"{name}: two runs of {args.steps} steps raised: {str(e)[:300]}")
            failed.append(name)
            continue
        print(f"{name}: two runs of {args.steps} steps, largest difference over every "
              f"parameter and buffer {state:.6e}, over the losses {losses:.6e}", flush=True)
        if state or losses:
            failed.append(name)
        torch.cuda.empty_cache()
    print("failed:", sorted(set(failed)) or "none")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
