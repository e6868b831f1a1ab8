#!/usr/bin/env python3
"""Time and profile the port's MMVit4 evaluation forward on one NVIDIA GPU.

    python3 scripts/profile_torch_eval.py [--batch 8] [--iters 10] [--out DIR]

At 224x224, bf16 compute, random weights from seed 0:

1. images/s of the forward (median of CUDA-event timed iterations after
   warm-up), with the kernels and with every kernel wrapper swapped for
   its plain PyTorch version, in turns: plain, kernels, kernels, plain;
2. a torch.profiler trace of a few forwards: device time by kernel name,
   and the device's busy share of the profiled wall time (union of kernel
   intervals over the host-clock window).

Writes ``profile.txt`` and ``trace.json`` under ``--out``. Fails without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from corrifnet_tpu_torch import ops  # noqa: E402
from corrifnet_tpu_torch.models import create_model  # noqa: E402

# where each wrapper is called on the evaluation path
_CALL_SITES = {
    "relu_instancenorm": ("corrifnet_tpu_torch.nn.conv", ops.relu_instancenorm_plain),
    "fused_attention": ("corrifnet_tpu_torch.nn.transformer", ops.attention_plain),
    "correlation_fusion": ("corrifnet_tpu_torch.models.mmvit4",
                           ops.correlation_fusion_plain),
}


@contextlib.contextmanager
def plain_versions():
    """Route every kernel call site of the forward to the plain version;
    raise if a kernel launched all the same (a call site not in the table)."""
    saved = []
    for name, (modname, plain) in _CALL_SITES.items():
        mod = sys.modules[modname]
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, plain)
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    launched = {n: w.launches for n, w in ops.KERNELS.items() if w.launches}
    if launched:
        raise RuntimeError(f"kernels launched in the plain run: {launched}")


def time_forward(model, x, iters):
    with torch.no_grad():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def busy_share(trace_path, wall_us):
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and "dur" in e)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            n, t = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, t + e["dur"])
    return busy / wall_us, busy, by_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile-forwards", type=int, default=3)
    ap.add_argument("--out", default="build/profile_eval")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_eval: no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    lines = [card, f"torch {torch.__version__}, batch {args.batch}, 224x224, bf16"]

    model = create_model("MMVit4", dtype=torch.bfloat16, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((args.batch, 3, 3, 224, 224), generator=gen, device="cuda")

    for label in ("plain", "kernels", "kernels", "plain"):
        ctx = plain_versions() if label == "plain" else contextlib.nullcontext()
        with ctx:
            med, lo, hi = time_forward(model, x, args.iters)
        lines.append(f"forward with {label:7s}: median {med:.3f} ms (min {lo:.3f}, "
                     f"max {hi:.3f}) -> {args.batch * 1000.0 / med:.2f} images/s")
        print(lines[-1], flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(args.profile_forwards):
                model(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    trace = out / "trace.json"
    prof.export_chrome_trace(str(trace))
    share, busy, by_name = busy_share(trace, wall_us)
    lines.append(f"profiled {args.profile_forwards} forwards: wall {wall_us / 1e3:.3f} ms, "
                 f"device busy {busy / 1e3:.3f} ms, busy share {share:.4f}")
    lines.append("device time by kernel name (total ms per forward, launches per forward):")
    total = sum(t for _, t in by_name.values())
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:40]:
        lines.append(f"  {t / 1e3 / args.profile_forwards:9.3f} ms "
                     f"{100 * t / total:5.1f}%  x{n // args.profile_forwards:<4d} {name[:140]}")
    lines.append(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=40))
    text = "\n".join(lines)
    (out / "profile.txt").write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
