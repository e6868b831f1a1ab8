#!/usr/bin/env python3
"""The attention kernels K2f and K2b alone, on one NVIDIA GPU.

    python3 scripts/bench_torch_attention.py

Runs the attention part of ``chip_smoke.py`` phase 3 and nothing else, at the
evaluation batch (8) and the training batch (4), so that a change to
``csrc/attention_*.cu`` is checked and timed in about a minute: for the
model's two attention shapes (N = 512 and 2048, 8 heads, head_dim 64), through
``fused_attention_qkv`` on the (B, N, 3, H, 64) projection, in f32 and bf16,
at dropout rate 0 and 0.1, the forward under ``no_grad`` and the forward with
its backward under autograd. The checks, bounds, timers and the lines printed
are ``chip_smoke``'s own (``check_attention_forward``, ``check_attention_step``,
``check_attention_strided``, ``check_keep_mask``): each line gives the errors
against the plain versions, the median of 10 single calls, the time per launch
of 20 queued launches with its TFLOP/s, ``F.scaled_dot_product_attention``
timed both ways (rate 0; timed only, the port never calls it) and the bound.
The backward at batch 8 is run here only; the model trains at batch 4.
Prints the card's name and power limit first; exits 1 if a check failed.
Imports no jax.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from corrifnet_tpu_torch import ops  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("bench_torch_attention: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tally = chip_smoke.Tally()
    chip_smoke.check_keep_mask(ops, tally)
    for b in (chip_smoke.EVAL_B, chip_smoke.TRAIN_B):
        sums = chip_smoke.Tally()
        chip_smoke.check_attention_forward(ops, sums, b, gen)
        sums.report(f"B={b} forward")
        tally.failures += sums.failures
        chip_smoke.check_attention_strided(ops, tally, b, gen)
        for rate in (0.0, chip_smoke.RATE):
            sums = chip_smoke.Tally()
            chip_smoke.check_attention_step(ops, sums, b, gen, rate)
            sums.report(f"B={b} rate {rate}")
            tally.failures += sums.failures
        torch.cuda.empty_cache()
    for what in tally.failures:
        print(f"FAILED: {what}", flush=True)
    return 1 if tally.failures else 0


if __name__ == "__main__":
    sys.exit(main())
