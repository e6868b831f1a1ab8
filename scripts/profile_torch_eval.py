#!/usr/bin/env python3
"""Time and profile the port's evaluation forward (MMVit4, MMVit2,
mmformer, RFNet or RobustMseg) on one NVIDIA GPU, under the entry points'
``deterministic()`` scope.

    python3 scripts/profile_torch_eval.py [--batch 8] [--iters 10]
        [--model MMVit4|MMVit2|mmformer|RFNet|RobustMseg] [--fused] [--lean none|true|false]
        [--out DIR]

At 224x224, bf16 compute, random weights from seed 0 (``--fused``: with
``pallas_fused_blocks``, the encoder bottlenecks through kernels K4a and K4c;
``--lean``: the config's ``decoder_lean``, none by default, which at batch 8
is the standard fused chain):

1. images/s of the forward (median of CUDA-event timed iterations after
   warm-up), with the kernels and with every kernel wrapper swapped for
   its plain PyTorch version, in turns: plain, kernels, kernels, plain;
2. a torch.profiler trace of a few forwards: device time by kind of kernel
   and by kernel name, and the device's busy share of the profiled wall time (union of kernel
   intervals over the host-clock window).

Writes ``profile.txt`` and ``trace.json`` under ``--out``. Fails without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from corrifnet_tpu_torch import ops  # noqa: E402
from corrifnet_tpu_torch.models import create_model  # noqa: E402
from corrifnet_tpu_torch.utils.determinism import deterministic  # noqa: E402



def _plain_pointwise(x, w, a=None, b=None, stats=True):
    y, s, q = ops.pointwise_conv_stats_plain(x.reshape(-1, x.shape[-1]), w, a, b)
    return y.view(*x.shape[:-1], -1), s, q


def _plain_conv3x3(x, w, a, b, stats=True):
    return ops.conv3x3_fma_relu_stats_plain(x, w, a, b)


def _plain_attention_qkv(qkv, scale, rate=0.0, philox=None):
    return ops.attention_plain(*qkv.permute(2, 0, 3, 1, 4).unbind(0), scale)


# the values of --lean
LEAN = {"none": None, "true": True, "false": False}

# (wrapper, the module that calls it on an evaluation path, its plain version)
_CALL_SITES = [
    ("relu_instancenorm", "corrifnet_tpu_torch.nn.conv", ops.relu_instancenorm_plain),
    ("fused_attention_qkv", "corrifnet_tpu_torch.nn.transformer", _plain_attention_qkv),
    ("correlation_fusion", "corrifnet_tpu_torch.models.mmvit4",
     ops.correlation_fusion_plain),
    ("correlation_fusion", "corrifnet_tpu_torch.models.mmvit2",
     ops.correlation_fusion_plain),
    ("pointwise_conv_stats", "corrifnet_tpu_torch.models.resnet3d", _plain_pointwise),
    ("conv3x3_fma_relu_stats", "corrifnet_tpu_torch.models.resnet3d", _plain_conv3x3),
]

# kind: substrings of the kernel name, first match wins
_KINDS = [
    ("K2b attention backward", ("attention_bwd", "attention_delta")),
    ("K2f attention forward", ("attention_fwd",)),
    ("K1b correlation backward", ("corr_bwd",)),
    ("K1f correlation forward", ("corr_fwd",)),
    ("K3 ReLU+InstanceNorm forward", ("relu_in_fwd", "stats", "merge", "normalize")),
    ("K3b ReLU+InstanceNorm backward", ("relu_in_bwd",)),
    ("replicate padding, forward and backward", ("replication_pad",)),
    ("trilinear up-sampling, forward and backward", ("upsample_trilinear",)),
    ("bilinear (H/W) up-sampling, forward and backward", ("upsample_bilinear",)),
    ("nearest up-sampling, forward and backward", ("upsample_nearest",)),
    ("cuDNN layout transforms", ("nchwToNhwc", "nhwcToNchw", "nchw2nhwc", "nhwc2nchw")),
    ("convolutions (cuDNN, forward, dgrad, wgrad)",
     ("cudnn", "conv", "xmma", "wgrad", "dgrad", "implicit_gemm", "fprop")),
    ("matmuls", ("gemm", "cutlass", "cublas", "gemv")),
    ("optimizer (multi-tensor Adam)", ("multi_tensor", "foreach", "adam")),
    ("max-pool, forward and backward", ("max_pool",)),
    ("reductions", ("reduce",)),
    ("copies, casts, cat", ("copy", "cat", "Memcpy", "Memset", "fill")),
    ("elementwise", ("elementwise", "vectorized")),
]
# the fused convolutions' kernels (csrc/fusedconv_common.cuh) by their
# template arguments: <T, taps, backward, ...> and <T, taps, ...>
_K4_ROWS = re.compile(r"rows_kernel<[^,]+, *(?:\(int\))?(\d), *(?:\(bool\))?(\w+)")
_K4_WGRAD = re.compile(r"wgrad_kernel<[^,]+, *(?:\(int\))?(\d)")
# the bf16 kernels on the tensor cores (csrc/fusedconv_wgmma.cuh,
# csrc/fusedconv_wgmma_bwd.cuh): the forwards and the backwards' dx passes
# <taps, block_n, vec, halo, backward>, the dw passes <taps, ...>, the g
# passes <taps, vec>
_K4_WGMMA = re.compile(r"conv_wgmma_kernel<(?:\(int\))?(\d),(?:[^,>]*,){3} *(?:\(bool\))?(\w+)>")
_K4_WGRAD_WGMMA = re.compile(r"wgrad_wgmma_kernel<(?:\(int\))?(\d)")
_K4_COTANGENT = re.compile(r"cotangent_kernel<(?:\(int\))?(\d)")


# host scopes whose kernels get a row of their own, whatever their names: the
# kernels launched inside K3's autograd node (the plain formula's dozens, or
# K3b), the channels-last copy in front of each K3 call (the scope that
# ``scoped_layout_copies`` opens), the lean stages' relu_in_stats (forward
# and backward), the input of a lean stage's conv made in the forward and
# rebuilt in the backward (fma, H/W resize, padding), and the depth
# expansion of the fused convs (the scopes ``scoped_decoder`` opens; its
# backward is the only bmm/baddbmm autograd node of the model)
K3_COPY_SCOPE = "K3 layout copy"
LEAN_INPUT_SCOPE = "lean stage input"
LEAN_REBUILD_SCOPE = "lean stage input rebuilt"
EXPANSION_SCOPE = "depth expansion"
_SCOPES = [
    ("K3 backward (every kernel under _ReluInstanceNormBackward)",
     "_ReluInstanceNormBackward"),
    ("K3 layout copies (permute + contiguous before each K3)", K3_COPY_SCOPE),
    ("relu_in_stats backward (every kernel under _ReluInStatsBackward)",
     "_ReluInStatsBackward"),
    ("relu_in_stats forward (relu, f32 statistics)", "_ReluInStats"),
    ("lean rebuild pass in the backward (fma, H/W resize, padding)", LEAN_REBUILD_SCOPE),
    ("lean stage input in the forward (fma, H/W resize, padding)", LEAN_INPUT_SCOPE),
    ("depth expansion backward (BmmBackward0, BaddbmmBackward0)", "BmmBackward0"),
    ("depth expansion backward (BmmBackward0, BaddbmmBackward0)", "BaddbmmBackward0"),
    ("depth expansion forward (tap regroup copy + product)", EXPANSION_SCOPE),
]


def kind_of(name):
    """The row of the by-kind table that a device kernel's name belongs to."""
    m = _K4_ROWS.search(name)
    if m:
        backward = m.group(2) in ("1", "true")
        pointwise = m.group(1) == "1"
        return {(True, False): "K4a fused 1x1 conv forward",
                (True, True): "K4b fused 1x1 conv backward (dx, da, db)",
                (False, False): "K4c fused 3x3 conv forward",
                (False, True): "K4d fused 3x3 conv backward (dx, da, db)"}[pointwise, backward]
    m = _K4_WGMMA.search(name)
    if m:
        if m.group(2) in ("1", "true"):
            return ("K4b fused 1x1 conv backward (dx, da, db)" if m.group(1) == "1"
                    else "K4d fused 3x3 conv backward (dx, da, db)")
        return "K4a fused 1x1 conv forward" if m.group(1) == "1" else "K4c fused 3x3 conv forward"
    m = _K4_WGRAD_WGMMA.search(name) or _K4_WGRAD.search(name)
    if m:
        return ("K4b fused 1x1 conv backward (dw)" if m.group(1) == "1"
                else "K4d fused 3x3 conv backward (dw)")
    m = _K4_COTANGENT.search(name)
    if m:
        return ("K4b fused 1x1 conv backward (g)" if m.group(1) == "1"
                else "K4d fused 3x3 conv backward (g)")
    if "reduce_partials" in name:
        return "K4a-d partial sums added in order"
    low = name.lower()
    for kind, needles in _KINDS:
        if any(n.lower() in low for n in needles):
            return kind
    return "other"


@contextlib.contextmanager
def scoped_layout_copies():
    """The model with profiler scopes around what gets a row of its own
    (the same computation): ``GeneralConv3d.forward``'s channels-last copy
    before K3 (``K3_COPY_SCOPE``), a lean stage's conv input (``LEAN_INPUT_SCOPE`` in
    the forward, ``LEAN_REBUILD_SCOPE`` when the backward rebuilds it) and
    the fused convs' depth expansion (``EXPANSION_SCOPE``)."""
    from corrifnet_tpu_torch.nn import conv, depthfuse, leandec

    general_forward = conv.GeneralConv3d.forward

    def forward(self, x, depth_fuse=None):
        if (self.order, self.act) != ("act_norm", "relu"):  # no K3 (RFNet's)
            return general_forward(self, x, depth_fuse)
        y = self.conv(x, depth_fuse)
        with torch.profiler.record_function(K3_COPY_SCOPE):
            y = y.permute(0, 2, 3, 4, 1).contiguous()
        return conv.relu_instancenorm(y).permute(0, 4, 1, 2, 3)

    prepare = leandec.LeanGeneralConv3d._prepare
    expand = depthfuse.depth_expand

    def scoped_prepare(self, x, depth_fuse):
        scope = LEAN_INPUT_SCOPE if torch.is_grad_enabled() else LEAN_REBUILD_SCOPE
        with torch.profiler.record_function(scope):
            return prepare(self, x, depth_fuse)

    def scoped_expand(*args, **kwargs):
        with torch.profiler.record_function(EXPANSION_SCOPE):
            return expand(*args, **kwargs)

    patches = [(conv.GeneralConv3d, "forward", forward),
               (leandec.LeanGeneralConv3d, "_prepare", scoped_prepare),
               (depthfuse, "depth_expand", scoped_expand)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def device_time_by_kind(trace_path):
    """{kind: (launches, device us)} of a trace. A kernel whose launch (the
    runtime call with its correlation id) lies inside a host scope of
    ``_SCOPES`` on the same thread counts there; the others by ``kind_of``."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    scopes = [(e["tid"], e["ts"], e["ts"] + e["dur"], kind) for e in events
              if e.get("cat") in ("cpu_op", "user_annotation") and "dur" in e
              for kind, needle in _SCOPES if needle in e.get("name", "")]
    launches = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    by_kind = {}
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        kind = kind_of(e["name"])
        tid, ts = launches.get(e.get("args", {}).get("correlation"), (None, None))
        for s_tid, start, end, scope_kind in scopes:
            if tid == s_tid and start <= ts <= end:
                kind = scope_kind
                break
        n, t = by_kind.get(kind, (0, 0.0))
        by_kind[kind] = (n + 1, t + e["dur"])
    return by_kind


@contextlib.contextmanager
def plain_versions():
    """Route every kernel call site of the forward to the plain version;
    raise if a kernel launched all the same (a call site not in the table)."""
    saved = []
    for name, modname, plain in _CALL_SITES:
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


@deterministic()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile-forwards", type=int, default=3)
    ap.add_argument("--model", choices=("MMVit4", "MMVit2", "mmformer", "RFNet", "RobustMseg"),
                    default="MMVit4",
                    help="the modeltype to profile")
    ap.add_argument("--fused", action="store_true",
                    help="build the model with pallas_fused_blocks")
    ap.add_argument("--lean", choices=sorted(LEAN), default="none",
                    help="the decoder's lean setting (decoder_lean)")
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
    lines = [card, f"torch {torch.__version__}, {args.model}, batch {args.batch}, "
                   f"224x224, bf16, pallas_fused_blocks {args.fused}, "
                   f"decoder_lean {LEAN[args.lean]}"]

    model = create_model(args.model, dtype=torch.bfloat16, device="cuda", seed=0,
                         pallas_fused_blocks=args.fused, decoder_lean=LEAN[args.lean])
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
        with scoped_layout_copies(), torch.profiler.profile(activities=activities) as prof:
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
    total = sum(t for _, t in by_name.values())
    n = args.profile_forwards
    lines.append(f"{sum(c for c, _ in by_name.values()) // n} kernel launches and "
                 f"{total / 1e3 / n:.3f} ms of device time per forward")
    by_kind = device_time_by_kind(trace)
    lines.append("device time by kind (ms per forward, share, launches per forward):")
    for kind, (count, t) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {t / 1e3 / n:9.3f} ms {100 * t / total:5.1f}%  x{count // n:<5d} {kind}")
    lines.append("device time by kernel name (total ms per forward, launches per forward):")
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
