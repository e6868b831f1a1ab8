#!/usr/bin/env python3
"""The bf16 fused bottleneck convs (forwards K4a, K4c; backwards K4b, K4d)
under other plans than ``ops.fusedconv.forward_plan``'s and
``backward_plan``'s, on one NVIDIA GPU.

    python3 scripts/bench_torch_fusedconv.py [--part forward|backward]

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

The backwards at every K4b and K4d shape at B=4 (a training step's), on the
forward's y and non-zero cotangents: the device time of one call (its three
launches: g, the dx pass, the dw pass) for each dx-pass block width (64, 128
columns) and split-K target (1, 66, 132 blocks), the dw pass as planned, and
for each dw-pass split target (66, 132, 264, 528 blocks), the dx pass as
planned; then the sums over one step. For the chosen plan also the
device time of each of the three passes. Every variant's dx, dw, da and db
are held to the chosen plan's within K4_BF16.
g is made once, by its own pass: a variant that makes it on the load was
not built.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from corrifnet_tpu_torch.ops import fusedconv as fc  # noqa: E402

TARGETS = (1, 66, 132, 264)
DX_TARGETS = (1, 66, 132)
# the backward's passes by kernel name (csrc/fusedconv_wgmma_bwd.cuh)
PASSES = (("cotangent_kernel", "g"), ("conv_wgmma_kernel", "dx"), ("wgrad_wgmma_kernel", "dw"))
DW_TARGETS = (66, 132, 264, 528)


def shapes(b):
    """(x shape, co, prologue, calls per forward) of every K4a and K4c call."""
    out = [((r, ci), co, pro, cs.ENCODERS * n) for r, ci, co, pro, n in cs.k4_pointwise_shapes(b)]
    return out + [(xs, xs[-1], True, cs.ENCODERS * n) for xs, n in cs.k4_conv_shapes(b)]


def backward_variants(rows, ci, co, taps):
    """(label, plan) of every backward variant: the dx pass's widths and
    targets with the dw pass as planned, then the dw pass's targets."""
    out = []
    for block_n in (64, 128):
        if block_n <= max(64, ci):
            out += [(f"dx n{block_n}/{t}", fc.backward_plan(rows, ci, co, taps, block_n, t))
                    for t in DX_TARGETS]
    return out + [(f"dw /{t}", fc.backward_plan(rows, ci, co, taps, dw_blocks=t))
                  for t in DW_TARGETS]


def bench_backward(gen):
    """The backward plan variants at B=4; returns True if a variant's
    gradients left K4_BF16 of the chosen plan's."""
    failed, sums = False, {}
    for xs, co, prologue, calls in shapes(4):
        taps = 1 if len(xs) == 2 else 9
        name = "K4b" if taps == 1 else "K4d"
        args = cs.fused_conv_inputs(gen, xs, co, prologue, torch.bfloat16)
        rows, ci = args[0].numel() // xs[-1], xs[-1]
        cots = (cs.randn((*xs[:-1], co), gen).bfloat16(), 0.3 * cs.randn((co,), gen),
                0.01 * cs.randn((co,), gen))
        chosen = fc.backward_plan(rows, ci, co, taps)
        cells = []
        with torch.no_grad():
            y = fc._launch_forward(*args, True, taps)[0]
            run = lambda: fc._launch_backward(*args, y, *cots, taps)  # noqa: E731
            want = [g for g in run() if g is not None]
            for label, plan in backward_variants(rows, ci, co, taps):
                with mock.patch.object(fc, "backward_plan", lambda *_, p=plan: p):
                    err = max(cs.rel_max(g, r) for g, r in
                              zip([g for g in run() if g is not None], want))
                    ms = cs.profiled_device_ms(run)
                failed |= not err <= cs.K4_BF16
                key = (name, label)
                sums[key] = sums.get(key, 0.0) + calls * ms
                split = plan[0][1] if label.startswith("dx") else plan[1][0]
                cells.append(f"{label} s{split}{'*' if plan == chosen else ''} {ms:.4f}"
                             + ("" if err <= cs.K4_BF16 else f" ERROR {err:.1e}"))
            passes = {}
            for kernel, k_ms in cs.profiled_device_ms(run, by_kernel=True).items():
                part = next((p for n, p in PASSES if n in kernel), kernel)
                passes[part] = passes.get(part, 0.0) + k_ms
            ms = sum(passes.values())
            for part, k_ms in passes.items():
                sums[(name, f"plan {part}")] = sums.get((name, f"plan {part}"), 0.0) + calls * k_ms
            sums[(name, "plan")] = sums.get((name, "plan"), 0.0) + calls * ms
        print(f"  B=4 backward {name} {xs} -> {co}{' prologue' if prologue else ''} x{calls}: "
              f"{'; '.join(cells)}; backward_plan {chosen} {ms:.4f} ("
              + ", ".join(f"{p} {v:.4f}" for p, v in passes.items()) + ")", flush=True)
    print(" B=4 backward sums over one step, ms (a dx width above ci counts only in "
          "n64): " + ", ".join(f"{k[0]} {k[1]} {v:.4f}" for k, v in sorted(sums.items())),
          flush=True)
    return failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("forward", "backward"), default=None,
                    help="time only the forwards or only the backwards")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_fusedconv: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = False
    if args.part != "forward":
        failed |= bench_backward(gen)
    if args.part == "backward":
        return 1 if failed else 0
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
