#!/usr/bin/env python3
"""The bf16 forwards of the fused bottleneck convs (K4a, K4c) under other
plans than ``ops.fusedconv.forward_plan``'s, on one NVIDIA GPU.

    python3 scripts/bench_torch_fusedconv.py

At every K4a and K4c shape of MMVit4's encoders, at B=4 with the
statistics (a training step's forwards) and at B=8 without them (an
evaluation forward), the device time of one call (the kernels of 20 calls
in a profiler trace, ``chip_smoke.profiled_device_ms``) for each block
width (64, 128 columns) and each split-K target (split the contraction
until the blocks reach 1, 66, 132 or 264, or one iteration a split:
``forward_plan``'s rule with that width and target, patched in for the
call), beside the plan that ``forward_plan`` picks; then, per kernel and batch, the sums
over the calls of one forward. Every variant's y is held to the chosen
plan's within ``chip_smoke.K4_BF16`` (split-K sums in another order); exit
code 1 if one is not. Fails without a GPU.
"""

from __future__ import annotations

import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from corrifnet_tpu_torch.ops import fusedconv as fc  # noqa: E402

TARGETS = (1, 66, 132, 264)


def shapes(b):
    """(x shape, co, prologue, calls per forward) of every K4a and K4c call."""
    out = [((r, ci), co, pro, cs.ENCODERS * n) for r, ci, co, pro, n in cs.k4_pointwise_shapes(b)]
    return out + [(xs, xs[-1], True, cs.ENCODERS * n) for xs, n in cs.k4_conv_shapes(b)]


def main():
    if not torch.cuda.is_available():
        print("bench_torch_fusedconv: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = False
    for b, stats in ((4, True), (8, False)):
        sums = {}
        for xs, co, prologue, calls in shapes(b):
            taps = 1 if len(xs) == 2 else 9
            name = "K4a" if taps == 1 else "K4c"
            args = cs.fused_conv_inputs(gen, xs, co, prologue, torch.bfloat16)
            rows, ci = args[0].numel() // xs[-1], xs[-1]
            chosen = fc.forward_plan(rows, ci, co, taps)
            cells = []
            with torch.no_grad():
                want = fc._launch_forward(*args, stats, taps)[0]
                for block_n in (64, 128):
                    if block_n > max(64, co):
                        continue
                    for target in TARGETS:
                        plan = fc.forward_plan(rows, ci, co, taps, block_n, target)
                        run = lambda: fc._launch_forward(*args, stats, taps)  # noqa: E731
                        with mock.patch.object(fc, "forward_plan", lambda *_, p=plan: p):
                            err = cs.rel_max(run()[0], want)
                            ms = cs.profiled_device_ms(run)
                        failed |= not err <= cs.K4_BF16
                        key = (name, block_n, target)
                        sums[key] = sums.get(key, 0.0) + calls * ms
                        mark = "*" if plan == chosen else ""
                        cells.append(f"n{block_n}/{target} s{plan[1]}{mark} {ms:.4f}"
                                     + ("" if err <= cs.K4_BF16 else f" ERROR {err:.1e}"))
                ms = cs.profiled_device_ms(lambda: fc._launch_forward(*args, stats, taps))
                sums[(name, "plan")] = sums.get((name, "plan"), 0.0) + calls * ms
            print(f"  B={b} {'with' if stats else 'without'} statistics {name} {xs} -> {co} "
                  f"x{calls}: {'; '.join(cells)}; forward_plan {chosen} {ms:.4f}", flush=True)
        print(f" B={b} sums over one forward, ms (64-column shapes count only in n64): "
              + ", ".join(f"{k[0]} {'plan' if k[1] == 'plan' else f'n{k[1]}/{k[2]}'} {v:.4f}"
                          for k, v in sorted(sums.items(), key=str)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
