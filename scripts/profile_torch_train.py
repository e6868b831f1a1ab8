#!/usr/bin/env python3
"""Time and profile the port's training step (MMVit4, MMVit2, mmformer,
RFNet or RobustMseg) on one NVIDIA GPU, under the entry points'
``deterministic()`` scope.

    python3 scripts/profile_torch_train.py [--batch 4] [--iters 10]
        [--model MMVit4|MMVit2|mmformer|RFNet|RobustMseg] [--fused] [--lean none|true|false]
        [--out DIR]

At 224x224, bf16 compute over f32 parameters, transformer dropout 0.1,
BatchNorm (MMVit4's) on batch statistics, Adam, random weights from seed 0
and a random batch that stays on the card (``--fused``: with ``pallas_fused_blocks``, the
encoder bottlenecks through kernels K4a-K4d, each a kind of its own below;
``--lean``: the config's ``decoder_lean``, none by default, which at batch 4
is the lean decoder):

1. the step (forward, backward, optimizer) timed with CUDA events: median
   of ``--iters`` steps after warm-up, patches/s, peak memory allocated;
2. a torch.profiler trace of a few steps: the device's busy share of the
   profiled wall time (union of kernel intervals over the host-clock
   window), device time by kind of kernel (the kernels under K3's autograd
   node, the channels-last copies before K3, relu_in_stats forward and
   backward, the lean stages' input made and rebuilt, and the depth
   expansion forward and backward each a row of their own)
   and by kernel name, and the launches of the port's own kernels per step.

Writes ``profile.txt`` and ``trace.json`` under ``--out``. Fails without a GPU.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from profile_torch_eval import (LEAN, busy_share, device_time_by_kind,  # noqa: E402
                                kind_of, scoped_layout_copies)

from corrifnet_tpu_torch import ops  # noqa: E402
from corrifnet_tpu_torch.models import create_model  # noqa: E402
from corrifnet_tpu_torch.utils.determinism import deterministic  # noqa: E402
from corrifnet_tpu_torch.nn import DropoutRng  # noqa: E402
from corrifnet_tpu_torch.train import init_state, make_train_step  # noqa: E402

@deterministic()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--model", choices=("MMVit4", "MMVit2", "mmformer", "RFNet", "RobustMseg"),
                    default="MMVit4",
                    help="the modeltype to profile")
    ap.add_argument("--fused", action="store_true",
                    help="build the model with pallas_fused_blocks")
    ap.add_argument("--lean", choices=sorted(LEAN), default="none",
                    help="the decoder's lean setting (decoder_lean)")
    ap.add_argument("--out", default="build/profile_train")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    lines = [card, f"torch {torch.__version__}, {args.model}, batch {args.batch}, "
                   f"224x224, bf16, dropout 0.1, Adam, pallas_fused_blocks "
                   f"{args.fused}, decoder_lean {LEAN[args.lean]}"]

    model = create_model(args.model, dtype=torch.bfloat16, device="cuda", seed=0,
                         pallas_fused_blocks=args.fused, decoder_lean=LEAN[args.lean])
    model.set_dropout_rng(DropoutRng(0, "cuda"))
    step = make_train_step(init_state(model, "Adam"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = args.batch
    x = torch.randn((b, 3, 3, 224, 224), generator=gen, device="cuda")
    masks = (torch.rand((b, 3, 1, 224, 224), generator=gen, device="cuda") > 0.7).float()
    valid = torch.ones(b, device="cuda")

    for _ in range(3):
        step(x, masks, valid, 1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(x, masks, valid, 1e-4)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    lines.append(f"train step: median {med:.3f} ms (min {min(times):.3f}, max "
                 f"{max(times):.3f}) over {args.iters} steps -> "
                 f"{b * 1000.0 / med:.3f} patches/s; peak memory allocated {peak} "
                 f"bytes ({peak / 2 ** 30:.3f} GiB)")
    print(lines[-1], flush=True)

    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with scoped_layout_copies(), torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profile_steps):
            step(x, masks, valid, 1e-4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = args.profile_steps
    trace = out / "trace.json"
    prof.export_chrome_trace(str(trace))
    share, busy, by_name = busy_share(trace, wall_us)
    total = sum(t for _, t in by_name.values())
    lines.append(f"profiled {n} steps: wall {wall_us / 1e3:.3f} ms, device busy "
                 f"{busy / 1e3:.3f} ms, busy share {share:.4f}; "
                 f"{sum(c for c, _ in by_name.values()) // n} kernel launches and "
                 f"{total / 1e3 / n:.3f} ms of device time per step")
    lines.append("the port's kernels, launches per step: " + ", ".join(
        f"{name} {w.launches / n:g}" for name, w in ops.KERNELS.items()))
    by_kind = device_time_by_kind(trace)
    lines.append("device time by kind (ms per step, share, launches per step):")
    for kind, (count, t) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {t / 1e3 / n:9.3f} ms {100 * t / total:5.1f}%  x{count // n:<5d} {kind}")
    lines.append("device time by kernel name (ms per step, share, launches per step):")
    for name, (count, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:40]:
        lines.append(f"  {t / 1e3 / n:9.3f} ms {100 * t / total:5.1f}%  x{count // n:<4d} "
                     f"[{kind_of(name)}] {name[:120]}")
    text = "\n".join(lines)
    (out / "profile.txt").write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
