#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (corrifnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result lines):

1. device: exit 1 when torch.cuda.is_available() is False; print the
   card's name and power limit as nvidia-smi gives them;
2. build: compile the CUDA C++ kernel with nvcc and load it;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the evaluation path gives it, first in f32 (TF32 off), then
   in bf16 against the plain version run in f32 on the same bf16 inputs;
   errors, bounds and median CUDA-event times of both;
4. the slice: the evaluation CLI (``run.evaluate.main``) over 16 synthetic
   224x224 images (fold 2 of 5 of 80) at batch 8 in bf16, with every
   launch counter reset just before and read just after; each kernel must
   have run on that path (K1 >= 1, K2 >= 2, K3 = 27 launches per forward);
   then over 96 images (fold 2 of 5 of 480), timed: the median seconds of
   the 11 batches after the first, with their spread;
5. whole model: one image (B=1) in f32 with TF32 off, through the kernels
   on the card and through the plain versions on the CPU, same weights:
   max |difference| of the probabilities <= 1e-4.

Then one JSON line of kernel results, the card line again, and last the
device line ``{"ok": true, "device": {...}}``. Imports no jax.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# kernel name: (route, source, the TPU kernel it replaces)
KERNEL_INFO = {
    "correlation_fusion": ("triton", "corrifnet_tpu_torch/ops/correlation.py",
                           "corrifnet_tpu/ops/correlation.py:59"),
    "fused_attention": ("cuda", "corrifnet_tpu_torch/csrc/attention_fwd.cu",
                        "corrifnet_tpu/ops/attention.py:206"),
    "relu_instancenorm": ("triton", "corrifnet_tpu_torch/ops/instancenorm.py",
                          "corrifnet_tpu/ops/instancenorm.py:67"),
}
B = 8  # per_image_metrics batch: max(mini_batch_size=4, 8)

# (shape, launches per forward) at B=8 on the evaluation path
K1_SHAPES = [((3, B, 512, 512), 1)]
K2_SHAPES = [((B, 8, 512, 64), 3), ((B, 8, 2048, 64), 1)]
K3_SHAPES = [
    ((B, 8, 8, 8, 192), 3), ((B, 3, 14, 14, 192), 3), ((B, 3, 28, 28, 96), 3),
    ((B, 3, 56, 56, 48), 3), ((B, 3, 56, 56, 24), 3), ((B, 16, 16, 16, 128), 1),
    ((B, 16, 16, 16, 64), 2), ((B, 32, 32, 32, 32), 3), ((B, 64, 64, 64, 16), 3),
    ((B, 128, 128, 128, 8), 3),
]
# f32 bounds against the plain version: sums in another order
F32_ATOL = {"correlation_fusion": 1e-6, "fused_attention": 2e-5,
            "relu_instancenorm": 1e-5}
F32_RTOL = {"correlation_fusion": 0.0, "fused_attention": 0.0,
            "relu_instancenorm": 1e-4}
# bf16 bound of K2: the probabilities and V meet in bf16-rounded inputs and
# 2048-long sums; the TPU kernel itself rounds p to bf16 before the PV
# product, which this kernel does not, so 2e-2 absolute is the bound
K2_BF16_ATOL = 2e-2
WHOLE_MODEL_ATOL = 1e-4
# patches of the timed evaluation: fold 2 of 5 is 96 images, 12 batches of 8
TIMED_SET = 480


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(ref):
    """One bf16 ulp at each element of ``ref`` (0 where ref is 0)."""
    _, exp = torch.frexp(ref.abs())
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)
    return torch.where(ref == 0, torch.zeros_like(ref), ulp)


def inputs_for(name, shape, gen):
    def randn(shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") + shift

    if name == "relu_instancenorm":
        return [randn(0.2)]
    return [randn() for _ in range(3)]


def check_kernel(name, wrapper, plain, shape, extra, gen):
    """Compare one kernel with its plain version at one shape, f32 then
    bf16; return (failed checks, max abs err bf16, kernel ms bf16, plain
    ms bf16)."""
    args32 = inputs_for(name, shape, gen)
    got = wrapper(*args32, *extra)
    want = plain(*args32, *extra)
    torch.cuda.synchronize()
    err = (got - want).abs()
    bound = F32_ATOL[name] + F32_RTOL[name] * want.abs()
    rel = (err / want.abs().clamp_min(1e-30)).max().item()
    log(f"  {name} {tuple(shape)} f32: max_abs {err.max().item():.3e} "
        f"max_rel {rel:.3e} bound atol {F32_ATOL[name]} rtol {F32_RTOL[name]}")
    failures = []
    if not bool((err <= bound).all()):
        failures.append(f"{name} {tuple(shape)} f32")

    args16 = [a.to(torch.bfloat16) for a in args32]
    got16 = wrapper(*args16, *extra)
    ref = plain(*(a.float() for a in args16), *extra)
    torch.cuda.synchronize()
    err16 = (got16.float() - ref).abs()
    if name == "fused_attention":
        bound16 = torch.full_like(ref, K2_BF16_ATOL)
        what = f"atol {K2_BF16_ATOL}"
    else:
        bound16 = 2 * bf16_ulp(ref) + F32_ATOL[name] + F32_RTOL[name] * ref.abs()
        what = "2 bf16 ulps + the f32 bound"
    rel16 = (err16 / ref.abs().clamp_min(1e-30)).max().item()
    log(f"  {name} {tuple(shape)} bf16: max_abs {err16.max().item():.3e} "
        f"max_rel {rel16:.3e} bound {what}")
    if not bool((err16 <= bound16).all()):
        failures.append(f"{name} {tuple(shape)} bf16")

    times = {}
    for label, args in (("f32", args32), ("bf16", args16)):
        k_ms = median_ms(lambda: wrapper(*args, *extra))
        p_ms = median_ms(lambda: plain(*args, *extra))
        times[label] = (k_ms, p_ms)
        log(f"  {name} {tuple(shape)} {label}: kernel {k_ms:.4f} ms "
            f"plain {p_ms:.4f} ms")
    torch.cuda.synchronize()
    return failures, err16.max().item(), times["bf16"][0], times["bf16"][1]


def phase_kernels(ops):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "correlation_fusion": (ops.correlation_fusion_plain, K1_SHAPES, ()),
        "fused_attention": (ops.attention_plain, K2_SHAPES, (0.125,)),
        "relu_instancenorm": (ops.relu_instancenorm_plain, K3_SHAPES, ()),
    }
    results, failures = {}, []
    for name, (plain, shapes, extra) in cases.items():
        worst, ms, plain_ms = 0.0, 0.0, 0.0
        for shape, per_forward in shapes:
            f, e, k, p = check_kernel(name, ops.KERNELS[name], plain, shape,
                                      extra, gen)
            failures += f
            worst = max(worst, e)
            ms += per_forward * k
            plain_ms += per_forward * p
        results[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
        log(f"  {name}: per-forward bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"kernels outside their bounds: {failures}")
    return results


def evaluate(n, tmp):
    """Drive the evaluation CLI over fold 2 of 5 of ``n`` synthetic patches:
    the 18-line defaults with MMVit4, as JSON, in the directory ``tmp``,
    which must be the working directory (cross_val reads randInd{n}.txt
    from there)."""
    from corrifnet_tpu_torch.run.evaluate import main as evaluate_main

    perm = np.random.default_rng(0).permutation(n)
    (Path(tmp) / f"randInd{n}.txt").write_text("\n".join(map(str, perm)) + "\n")
    cfg = Path(tmp) / f"eval{n}.json"
    cfg.write_text(json.dumps({"train_set_size": n, "fno": 2, "fsiz": 5,
                               "modeltype": "MMVit4", "synthetic_seed": 0}))
    return evaluate_main(["--config", str(cfg), "--device", "cuda"])


def phase_slice(ops):
    """16 images through the entry point with the launch counters reset
    just before and read just after; then a test fold of 96 images (12
    batches) timed through the same entry point."""
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.reset_peak_memory_stats()
            for wrapper in ops.KERNELS.values():
                wrapper.launches = 0
            r = evaluate(80, tmp)
            torch.cuda.synchronize()
            launches = {n: w.launches for n, w in ops.KERNELS.items()}
            peak = torch.cuda.max_memory_allocated()
            timed = evaluate(TIMED_SET, tmp)
        finally:
            os.chdir(here)
    forwards = len(r["batch_seconds"])
    log(f"  jaccard2 {r['jaccard_mean']:.6f} +- {r['jaccard_std']:.6f}  "
        f"f1 {r['f1_mean']:.6f} +- {r['f1_std']:.6f}  n_images {r['n_images']}")
    log(f"  batch seconds {r['batch_seconds']}; peak memory allocated {peak} "
        f"bytes ({peak / 2 ** 30:.3f} GiB)")
    log(f"  launches over {forwards} forwards: {launches}")
    if r["n_images"] != 16 or r["batch_size"] != B:
        raise AssertionError(f"expected 16 images at batch {B}: {r}")
    for key in ("jaccard_mean", "f1_mean"):
        if not 0.0 <= r[key] <= 1.0:
            raise AssertionError(f"{key} out of [0, 1]: {r[key]}")
    per_forward = {n: c / forwards for n, c in launches.items()}
    if not (per_forward["correlation_fusion"] >= 1
            and per_forward["fused_attention"] >= 2
            and per_forward["relu_instancenorm"] == 27):
        raise AssertionError(f"kernel launches per forward: {per_forward}")

    rest = timed["batch_seconds"][1:]
    med = statistics.median(rest)
    log(f"  timed: {timed['n_images']} images, {len(rest)} batches of {B} after "
        f"one warm-up; batch seconds median {med:.4f} (min {min(rest):.4f}, "
        f"max {max(rest):.4f}); images/s {B / med:.3f} (from the min "
        f"{B / max(rest):.3f}, from the max {B / min(rest):.3f})")
    if timed["n_images"] != TIMED_SET // 5 or len(rest) < 10:
        raise AssertionError(f"timed run: {timed['n_images']} images, "
                             f"{len(rest)} timed batches")
    return launches


def phase_whole_model():
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.testing import calibrate_batchnorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn((1, 3, 3, 224, 224), generator=torch.Generator().manual_seed(0))
    cpu = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=0)
    # O(1) activations, as trained statistics give (see calibrate_batchnorm)
    calibrate_batchnorm(cpu, x)
    gpu = copy.deepcopy(cpu).to("cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        out_gpu = gpu(x.to("cuda")).cpu()
        t1 = time.perf_counter()
        out_cpu = cpu(x)
        t2 = time.perf_counter()
    diff = (out_gpu - out_cpu).abs().max().item()
    log(f"  B=1 f32 GPU {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; max |GPU - CPU| "
        f"{diff:.3e} (bound {WHOLE_MODEL_ATOL}); shape {tuple(out_gpu.shape)}")
    if out_gpu.shape != (1, 3, 1, 224, 224) or not bool(torch.isfinite(out_gpu).all()):
        raise AssertionError("whole-model output malformed")
    if not diff <= WHOLE_MODEL_ATOL:
        raise AssertionError(f"whole model GPU vs CPU {diff} > {WHOLE_MODEL_ATOL}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # before any output: run without the package, the script prints nothing
    from corrifnet_tpu_torch import ops
    from corrifnet_tpu_torch.ops.build import BUILD_DIR, load_cuda_library

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    t0 = time.perf_counter()
    load_cuda_library("attention_fwd.cu")
    log(f"  nvcc build + load {time.perf_counter() - t0:.2f} s")
    for report in sorted(BUILD_DIR.glob("*.log")):
        log(f"  {report.name}:\n{report.read_text().strip()}")

    log("phase 3: kernels against their plain versions")
    t0 = time.perf_counter()
    results = phase_kernels(ops)
    torch.cuda.synchronize()
    log(f"  phase 3 took {time.perf_counter() - t0:.2f} s (Triton compiles included)")

    log("phase 4: evaluation slice, 16 images, B=8, bf16")
    launches = phase_slice(ops)
    torch.cuda.synchronize()

    log("phase 5: whole model, B=1 f32, GPU kernels vs CPU plain versions")
    phase_whole_model()
    torch.cuda.synchronize()

    kernels = []
    for name, r in results.items():
        route, source, replaces = KERNEL_INFO[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name], **r})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
