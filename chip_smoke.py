#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (corrifnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result lines):

1. device: exit 1 when torch.cuda.is_available() is False; print the
   card's name and power limit as nvidia-smi gives them;
2. build: compile both CUDA C++ sources with nvcc (in parallel) and load them;
3. kernels: each kernel against its plain PyTorch version on the card,
   first in f32 (TF32 off), then in bf16 against the plain version run in
   f32 on the same bf16 inputs; errors, bounds and median CUDA-event times
   of the kernel, the plain version and, where one PyTorch call computes the
   same function, that call. Every kernel is reached as the paths reach
   it: the forward kernels at the evaluation shapes (B=8) through their
   wrappers with no gradient asked for (K2f without the logsumexp), then all five
   at the training shapes (B=4) through the wrappers on leaves that need
   gradients and ``backward``: K1f, K1b, K2f with dropout 0.1 and the
   logsumexp, K2b at rate 0 and 0.1, K3. With dropout on, the plain
   version gets the kernels' Philox mask and the comparison is element by
   element; the mask the kernels' device function writes is held against
   ``philox_keep_mask`` exactly;
4. the evaluation slice: ``run.evaluate.main`` over 16 synthetic 224x224
   images at batch 8 in bf16, with every launch counter reset just before
   and read just after (K1 >= 1, K2 >= 2, K3 = 27 launches per forward);
   then over 48 images, timed;
5. the training slice: ``run.main.main`` at full width (MMVit4, 224x224,
   B=4, bf16, dropout 0.1) for one epoch of 8 steps over 40 synthetic
   patches, with validation by checkpoint and the test; counters reset just
   before and read just after: per training step K1f 1, K1b 1, K2f 4, K2b 4
   (its delta, dq and dk/dv passes count as one launch), K3 27; the log
   files and both checkpoints exist; losses in the double-sigmoid band;
   step seconds, patches/s and peak memory are printed;
6. whole model: one image (B=1) in f32 with TF32 off, through the kernels
   on the card and through the plain versions on the CPU, same weights:
   max |difference| of the probabilities <= 1e-4;
7. one training step (B=1, f32, TF32 off, dropout 0) on the card against
   the CPU: the loss within 1e-5, and every gradient tensor's relative L2
   distance within twice the worst that the CPU shows against itself
   when the input changes by one part in 10^6 (measured in the run).

Then one JSON line of kernel results, the card line again, and last the
device line ``{"ok": true, "device": {...}}``. Imports no jax.

``bound_ms`` is the least time the card could take: the larger of the
bytes the function must move (each input read once, each output written
once) over the H100 SXM's 3.35 TB/s and its operations over 989 TFLOP/s
(dense bf16 tensor rate), both from NVIDIA's data sheet.
"""

from __future__ import annotations

import concurrent.futures
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
import torch.nn.functional as F

# kernel name: (route, source, the TPU kernel it replaces)
KERNEL_INFO = {
    "correlation_fusion": ("triton", "corrifnet_tpu_torch/ops/correlation.py",
                           "corrifnet_tpu/ops/correlation.py:59"),
    "correlation_fusion_bwd": ("triton", "corrifnet_tpu_torch/ops/correlation.py",
                               "corrifnet_tpu/ops/correlation.py:74"),
    "fused_attention": ("cuda", "corrifnet_tpu_torch/csrc/attention_fwd.cu",
                        "corrifnet_tpu/ops/attention.py:206"),
    "fused_attention_bwd": ("cuda", "corrifnet_tpu_torch/csrc/attention_bwd.cu",
                            "corrifnet_tpu/ops/attention.py:300"),
    "relu_instancenorm": ("triton", "corrifnet_tpu_torch/ops/instancenorm.py",
                          "corrifnet_tpu/ops/instancenorm.py:67"),
}
CUDA_SOURCES = ("attention_fwd.cu", "attention_bwd.cu")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core rate, same sheet
EVAL_B = 8   # per_image_metrics batch: max(mini_batch_size=4, 8)
TRAIN_B = 4  # mini_batch_size


def k1_shape(b):
    return (3, b, 512, 512)


def k2_shapes(b):
    """(shape, launches per forward) of the two attention shapes."""
    return [((b, 8, 512, 64), 3), ((b, 8, 2048, 64), 1)]


def k3_shapes(b):
    """(shape, launches per forward) of the 27 decoder epilogues."""
    return [
        ((b, 8, 8, 8, 192), 3), ((b, 3, 14, 14, 192), 3), ((b, 3, 28, 28, 96), 3),
        ((b, 3, 56, 56, 48), 3), ((b, 3, 56, 56, 24), 3), ((b, 16, 16, 16, 128), 1),
        ((b, 16, 16, 16, 64), 2), ((b, 32, 32, 32, 32), 3), ((b, 64, 64, 64, 16), 3),
        ((b, 128, 128, 128, 8), 3),
    ]


# f32 bounds against the plain version: sums in another order
K1_ATOL = 1e-6
K2_ATOL = 2e-5
K3_ATOL, K3_RTOL = 1e-5, 1e-4
# K2 gradients: 2e-5 of the largest gradient (N-long sums of products)
K2_GRAD_RTOL = 2e-5
# bf16 bounds of K2: inputs rounded to bf16 meet in 2048-long sums, and the
# outputs are rounded to bf16. The TPU kernel also rounds p to bf16 before
# its PV and dv products; these kernels keep p in f32, the more accurate
# side, so 2e-2 absolute on the output (values O(1)) and 2e-2 of the largest
# gradient are generous
K2_BF16_ATOL = 2e-2
K2_BF16_GRAD_RTOL = 2e-2
WHOLE_MODEL_ATOL = 1e-4
# one f32 training step, card against CPU: the loss, and the gradients'
# relative L2 distance as a multiple of what the CPU shows against itself
# under a 1e-6 change of the input (see phase_train_step)
STEP_LOSS_ATOL, STEP_WITNESS_FACTOR = 1e-5, 2.0
SCALE = 0.125
RATE = 0.1
PHILOX = (20260, 17)
# the timed evaluation: fold 2 of 5 of 240 patches is 48 images, 6 batches of 8
TIMED_SET = 240
TRAIN_SET = 40  # 29 training patches (8 steps of 4), 3 validation, 8 test


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, reps=10):
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


def randn(shape, gen, shift=0.0):
    return torch.randn(shape, generator=gen, device="cuda") + shift


class Tally:
    """Per-kernel sums over the calls of one forward or one training step."""

    def __init__(self):
        self.rows, self.failures, self.bound_kinds = {}, [], {}

    def add(self, name, calls, err, ms, plain_ms, bound_ms, bound_by, library_ms):
        r = self.rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": bound_by, "library_ms": None if library_ms is None else 0.0})
        by = self.bound_kinds.setdefault(name, {"bytes": 0.0, "operations": 0.0})
        by[bound_by] += calls * bound_ms
        r["bound_by"] = max(by, key=by.get)  # what bounds most of the sum
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += calls * ms
        r["plain_ms"] += calls * plain_ms
        r["bound_ms"] += calls * bound_ms
        if library_ms is not None:
            r["library_ms"] += calls * library_ms

    def check(self, ok, what):
        if not bool(ok):
            self.failures.append(what)

    def report(self, title):
        for name, r in self.rows.items():
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"  {title} {name}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {lib}, max_abs_err bf16 "
                f"{r['max_abs_err']:.3e}")


def bytes_bound_ms(n_values, itemsize=2):
    return n_values * itemsize / HBM_BYTES_PER_S * 1e3


def attention_bound_ms(shape, products, tensors, lse=True):
    """max(bytes, operations) for ``products`` N x N x 64 matrix products and
    ``tensors`` (B, H, N, 64) bf16 operands moved once, plus the f32 lse."""
    b, h, n, d = shape
    flops = products * 2 * b * h * n * n * d
    moved = tensors * b * h * n * d * 2 + (b * h * n * 4 if lse else 0)
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------------ kernels


def check_correlation(ops, tally, b, gen, backward):
    shape = k1_shape(b)
    q, k, v, g = (randn(shape, gen) for _ in range(4))
    q16, k16, v16, g16 = (t.bfloat16() for t in (q, k, v, g))
    m = q[0].numel()
    name = "correlation_fusion"
    got = ops.correlation_fusion(q, k, v)
    want = ops.correlation_fusion_plain(q, k, v)
    err = (got - want).abs().max().item()
    tally.check(err <= K1_ATOL, f"{name} {shape} f32 {err:.3e}")
    ref = ops.correlation_fusion_plain(q16.float(), k16.float(), v16.float())
    e16 = (ops.correlation_fusion(q16, k16, v16).float() - ref).abs()
    tally.check((e16 <= 2 * bf16_ulp(ref) + K1_ATOL).all(), f"{name} {shape} bf16")
    log(f"  {name} {shape}: f32 max_abs {err:.3e} (bound {K1_ATOL}); bf16 max_abs "
        f"{e16.max().item():.3e} (bound 2 bf16 ulps + {K1_ATOL})")
    tally.add(name, 1, e16.max().item(),
              median_ms(lambda: ops.correlation_fusion(q16, k16, v16)),
              median_ms(lambda: ops.correlation_fusion_plain(q16, k16, v16)),
              bytes_bound_ms(12 * m), "bytes", None)
    if not backward:
        return
    name = "correlation_fusion_bwd"
    got = ops.correlation_fusion_bwd(q, k, v, g)
    want = ops.correlation_fusion_backward_plain(q, k, v, g)
    err = max((a - w).abs().max().item() for a, w in zip(got, want))
    tally.check(all(((a - w).abs() <= K1_ATOL + K1_ATOL * w.abs()).all()
                    for a, w in zip(got, want)), f"{name} {shape} f32 {err:.3e}")
    got16 = ops.correlation_fusion_bwd(q16, k16, v16, g16)
    ref = ops.correlation_fusion_backward_plain(*(t.float() for t in (q16, k16, v16, g16)))
    e16 = max((a.float() - w).abs().max().item() for a, w in zip(got16, ref))
    tally.check(all(((a.float() - w).abs() <= 2 * bf16_ulp(w) + K1_ATOL).all()
                    for a, w in zip(got16, ref)), f"{name} {shape} bf16")
    # the same kernel as autograd reaches it, from the tensors the function saved
    leaves = [t.clone().requires_grad_() for t in (q16, k16, v16)]
    ops.correlation_fusion(*leaves).backward(g16)
    same = all(torch.equal(leaf.grad, d) for leaf, d in zip(leaves, got16))
    tally.check(same, f"{name} {shape}: autograd and the direct call differ")
    log(f"  {name} {shape}: f32 max_abs {err:.3e} (bound {K1_ATOL} + {K1_ATOL} rel); "
        f"bf16 max_abs {e16:.3e} (bound 2 bf16 ulps + {K1_ATOL}); through autograd "
        f"equal to the direct call: {same}")
    tally.add(name, 1, e16,
              median_ms(lambda: ops.correlation_fusion_bwd(q16, k16, v16, g16)),
              median_ms(lambda: ops.correlation_fusion_backward_plain(q16, k16, v16, g16)),
              bytes_bound_ms(21 * m), "bytes", None)


def check_instancenorm(ops, tally, b, gen):
    name = "relu_instancenorm"
    for shape, calls in k3_shapes(b):
        x = randn(shape, gen, 0.2)
        x16 = x.bfloat16()
        got, want = ops.relu_instancenorm(x), ops.relu_instancenorm_plain(x)
        err = (got - want).abs()
        tally.check((err <= K3_ATOL + K3_RTOL * want.abs()).all(),
                    f"{name} {shape} f32 {err.max().item():.3e}")
        ref = ops.relu_instancenorm_plain(x16.float())
        e16 = (ops.relu_instancenorm(x16).float() - ref).abs()
        tally.check((e16 <= 2 * bf16_ulp(ref) + K3_ATOL + K3_RTOL * ref.abs()).all(),
                    f"{name} {shape} bf16")
        ncdhw = x16.permute(0, 4, 1, 2, 3).contiguous()
        k_ms = median_ms(lambda: ops.relu_instancenorm(x16))
        p_ms = median_ms(lambda: ops.relu_instancenorm_plain(x16))
        l_ms = median_ms(lambda: F.instance_norm(F.relu(ncdhw)))
        log(f"  {name} {shape}: f32 max_abs {err.max().item():.3e} (bound {K3_ATOL} + "
            f"{K3_RTOL} rel); bf16 max_abs {e16.max().item():.3e} (bound 2 bf16 ulps "
            f"+ the f32 bound); bf16 kernel {k_ms:.4f} plain {p_ms:.4f} library "
            f"{l_ms:.4f} ms")
        tally.add(name, calls, e16.max().item(), k_ms, p_ms,
                  bytes_bound_ms(2 * x.numel()), "bytes", l_ms)


def plain_attention_graph(ops, q, k, v, rate, keep):
    """(output, leaves) of the plain version run in f32 under autograd."""
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    return ops.attention_plain(*leaves, SCALE, rate, keep), leaves


def attention_step(ops, q, k, v, g, rate):
    """What a training step runs: ``fused_attention`` on leaves that need
    gradients (K2f writing the lse) and its backward (K2b on the tensors the
    function saved). Returns the output, the leaves with their gradients,
    and the graph's output for timing further backwards."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = ops.fused_attention(*leaves, SCALE, rate, PHILOX)
    out.backward(g, retain_graph=True)
    return out.detach(), leaves, out


def check_attention_forward(ops, tally, b, gen):
    """K2f as the evaluation path launches it: ``fused_attention`` at rate 0
    under ``no_grad``, so without the lse."""
    name = "fused_attention"
    for shape, calls in k2_shapes(b):
        q, k, v = (randn(shape, gen) for _ in range(3))
        q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
        with torch.no_grad():
            err = (ops.fused_attention(q, k, v, SCALE)
                   - ops.attention_plain(q, k, v, SCALE)).abs().max().item()
            ref16 = ops.attention_plain(q16.float(), k16.float(), v16.float(), SCALE)
            e16 = (ops.fused_attention(q16, k16, v16, SCALE).float()
                   - ref16).abs().max().item()
            k_ms = median_ms(lambda: ops.fused_attention(q16, k16, v16, SCALE))
            p_ms = median_ms(lambda: ops.attention_plain(q16, k16, v16, SCALE))
            l_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q16, k16, v16, scale=SCALE))
        tally.check(err <= K2_ATOL, f"{name} {shape} no lse f32 {err:.3e}")
        tally.check(e16 <= K2_BF16_ATOL, f"{name} {shape} no lse bf16 {e16:.3e}")
        bound, by = attention_bound_ms(shape, 2, 4, lse=False)
        log(f"  {name} {shape} rate 0, no lse (under no_grad): f32 max_abs {err:.3e} "
            f"(bound {K2_ATOL}); bf16 max_abs {e16:.3e} (bound {K2_BF16_ATOL}); bf16 "
            f"kernel {k_ms:.4f} plain {p_ms:.4f} library (SDPA) {l_ms:.4f} bound "
            f"{bound:.4f} ms ({by})")
        tally.add(name, calls, e16, k_ms, p_ms, bound, by, l_ms)


def check_attention_step(ops, tally, b, gen, rate):
    """K2f with the lse and K2b as a training step launches them: through
    ``fused_attention`` on leaves that need gradients and ``backward``. With
    ``rate`` > 0 the plain version is given ``philox_keep_mask`` of the
    kernels' Philox key. The direct call of ``fused_attention_bwd`` on a
    separately launched forward's output and lse must give the same bits."""
    from corrifnet_tpu_torch.ops import attention as attn

    for shape, calls in k2_shapes(b):
        bb, h, n, _ = shape
        q, k, v, g = (randn(shape, gen) for _ in range(4))
        q16, k16, v16, g16 = (t.bfloat16() for t in (q, k, v, g))
        keep = None
        if rate > 0:
            keep = ops.philox_keep_mask(*PHILOX, bb * h, n, rate, "cuda").view(bb, h, n, n)
        tag = f"{shape} rate {rate}"
        fwd, bwd = "fused_attention", "fused_attention_bwd"

        # f32: output and gradients through the wrapper against the plain version
        out, leaves, _ = attention_step(ops, q, k, v, g, rate)
        po, plain_leaves = plain_attention_graph(ops, q, k, v, rate, keep)
        err = (out - po.detach()).abs().max().item()
        tally.check(err <= K2_ATOL, f"{fwd} {tag} f32 {err:.3e}")
        want = torch.autograd.grad(po, plain_leaves, g)
        gerr = 0.0
        for leaf, w in zip(leaves, want):
            gerr = max(gerr, (leaf.grad - w).abs().max().item())
            tally.check(((leaf.grad - w).abs() <= K2_GRAD_RTOL * w.abs().max() + 1e-6).all(),
                        f"{bwd} {tag} f32 {gerr:.3e}")
        del po, plain_leaves, want
        # the lse of a direct launch against logsumexp, and the direct
        # backward on it against the gradients autograd delivered
        out2, lse = attn._launch_fwd(q, k, v, SCALE, rate, *PHILOX, True)
        scores = torch.einsum("bhnd,bhmd->bhnm", q, k) * SCALE
        lse_err = (lse - torch.logsumexp(scores, dim=-1)).abs().max().item()
        del scores
        tally.check(lse_err <= 1e-5, f"{fwd} {tag} lse {lse_err:.3e}")
        direct = ops.fused_attention_bwd(q, k, v, out2, lse, g, SCALE, rate, PHILOX)
        same = torch.equal(out, out2) and all(
            torch.equal(leaf.grad, d) for leaf, d in zip(leaves, direct))
        tally.check(same, f"{bwd} {tag} f32: autograd and the direct call differ")

        # bf16 against the plain version in f32 on the same bf16 inputs
        out16, leaves16, graph16 = attention_step(ops, q16, k16, v16, g16, rate)
        po, plain_leaves = plain_attention_graph(ops, q16, k16, v16, rate, keep)
        e16 = (out16.float() - po.detach()).abs().max().item()
        tally.check(e16 <= K2_BF16_ATOL, f"{fwd} {tag} bf16 {e16:.3e}")
        ref = torch.autograd.grad(po, plain_leaves, g16.float())
        ge16 = 0.0
        for leaf, w in zip(leaves16, ref):
            ge16 = max(ge16, (leaf.grad.float() - w).abs().max().item())
            tally.check(((leaf.grad.float() - w).abs()
                         <= K2_BF16_GRAD_RTOL * w.abs().max()).all(),
                        f"{bwd} {tag} bf16 {ge16:.3e}")
        del po, plain_leaves, ref

        # times, bf16: forward and backward through the wrapper, as the step runs them
        k_ms = median_ms(lambda: ops.fused_attention(*leaves16, SCALE, rate, PHILOX))
        p_ms = median_ms(lambda: ops.attention_plain(q16, k16, v16, SCALE, rate, keep))
        l_ms = median_ms(lambda: F.scaled_dot_product_attention(q16, k16, v16, scale=SCALE))
        bound, by = attention_bound_ms(shape, 2, 4)
        log(f"  {fwd} {tag}, lse (through autograd): f32 max_abs {err:.3e} (bound "
            f"{K2_ATOL}), lse {lse_err:.3e} (bound 1e-5); bf16 max_abs {e16:.3e} (bound "
            f"{K2_BF16_ATOL}); bf16 kernel {k_ms:.4f} plain {p_ms:.4f} library (SDPA, "
            f"rate 0) {l_ms:.4f} bound {bound:.4f} ms ({by})")
        tally.add(fwd, calls, e16, k_ms, p_ms, bound, by, l_ms)

        k_ms = median_ms(lambda: torch.autograd.grad(graph16, leaves16, g16, retain_graph=True))
        lp = [t.clone().requires_grad_() for t in (q16, k16, v16)]
        po = ops.attention_plain(*lp, SCALE, rate, keep)
        p_ms = median_ms(lambda: torch.autograd.grad(po, lp, g16, retain_graph=True))
        ll = [t.clone().requires_grad_() for t in (q16, k16, v16)]
        lo = F.scaled_dot_product_attention(*ll, scale=SCALE)
        l_ms = median_ms(lambda: torch.autograd.grad(lo, ll, g16, retain_graph=True))
        del po, lo, graph16
        bound, by = attention_bound_ms(shape, 5, 8)
        log(f"  {bwd} {tag} (through autograd, equal to the direct call: {same}): f32 "
            f"max_abs {gerr:.3e} (bound {K2_GRAD_RTOL} of max|grad| + 1e-6); bf16 max_abs "
            f"{ge16:.3e} (bound {K2_BF16_GRAD_RTOL} of max|grad|); bf16 kernel {k_ms:.4f} "
            f"plain (autograd) {p_ms:.4f} library (SDPA backward, rate 0) {l_ms:.4f} "
            f"bound {bound:.4f} ms ({by})")
        tally.add(bwd, calls, ge16, k_ms, p_ms, bound, by, l_ms)


def check_keep_mask(ops, tally):
    from corrifnet_tpu_torch.ops.attention import kernel_keep_mask

    n, count, bh0 = 2048, 3, 13
    got = kernel_keep_mask(*PHILOX, bh0, count, n, RATE)
    want = ops.philox_keep_mask(*PHILOX, count, n, RATE, "cuda", bh0=bh0)
    same = torch.equal(got, want)
    rate = got.float().mean().item()
    sigma = (RATE * (1 - RATE) / got.numel()) ** 0.5
    log(f"  keep mask ({count}, {n}, {n}) from the kernel's device function equals "
        f"philox_keep_mask: {same}; keep rate {rate:.6f} (0.9 +- 4 sigma = "
        f"{4 * sigma:.6f}); rows differ between heads: "
        f"{not torch.equal(got[0], got[1])}")
    tally.check(same, "keep mask differs from philox_keep_mask")
    tally.check(abs(rate - (1 - RATE)) <= 4 * sigma, f"keep rate {rate}")
    tally.check(not torch.equal(got[0], got[1]), "keep mask repeats across heads")


def phase_kernels(ops):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    log(f" evaluation shapes (B={EVAL_B}), forward kernels, sums over one forward:")
    fwd = Tally()
    check_correlation(ops, fwd, EVAL_B, gen, backward=False)
    check_attention_forward(ops, fwd, EVAL_B, gen)
    check_instancenorm(ops, fwd, EVAL_B, gen)
    fwd.report(f"B={EVAL_B} forward")
    torch.cuda.empty_cache()
    log(f" training shapes (B={TRAIN_B}), sums over one training step:")
    step = Tally()
    check_correlation(ops, step, TRAIN_B, gen, backward=True)
    rate0 = Tally()
    check_attention_step(ops, rate0, TRAIN_B, gen, 0.0)
    rate0.report(f"B={TRAIN_B} rate 0")
    check_attention_step(ops, step, TRAIN_B, gen, RATE)
    check_keep_mask(ops, step)
    check_instancenorm(ops, step, TRAIN_B, gen)
    step.report(f"B={TRAIN_B} training step")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    failures = fwd.failures + rate0.failures + step.failures
    if failures:
        raise AssertionError(f"kernels outside their bounds: {failures}")
    return step.rows


# ------------------------------------------------------------------ slices


def write_run_inputs(n, tmp, name, **extra):
    """randInd{n}.txt and a JSON config (the 18-line defaults with MMVit4)
    in ``tmp``, which must be the working directory: cross_val reads the
    permutation from there."""
    perm = np.random.default_rng(0).permutation(n)
    (Path(tmp) / f"randInd{n}.txt").write_text("\n".join(map(str, perm)) + "\n")
    cfg = Path(tmp) / name
    cfg.write_text(json.dumps({"train_set_size": n, "fno": 2, "fsiz": 5,
                               "modeltype": "MMVit4", "synthetic_seed": 0, **extra}))
    return cfg


def evaluate(n, tmp):
    """Drive the evaluation CLI over fold 2 of 5 of ``n`` synthetic patches."""
    from corrifnet_tpu_torch.run.evaluate import main as evaluate_main

    cfg = write_run_inputs(n, tmp, f"eval{n}.json")
    return evaluate_main(["--config", str(cfg), "--device", "cuda"])


def reset_counts(ops):
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0


def read_counts(ops):
    torch.cuda.synchronize()
    return {n: w.launches for n, w in ops.KERNELS.items()}


def phase_eval_slice(ops, tmp):
    """16 images through the entry point with the launch counters reset
    just before and read just after; then a test fold of 48 images (6
    batches) timed through the same entry point."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    r = evaluate(80, tmp)
    launches = read_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    timed = evaluate(TIMED_SET, tmp)
    forwards = len(r["batch_seconds"])
    log(f"  jaccard2 {r['jaccard_mean']:.6f} +- {r['jaccard_std']:.6f}  "
        f"f1 {r['f1_mean']:.6f} +- {r['f1_std']:.6f}  n_images {r['n_images']}")
    log(f"  batch seconds {r['batch_seconds']}; peak memory allocated {peak} "
        f"bytes ({peak / 2 ** 30:.3f} GiB)")
    log(f"  launches over {forwards} forwards: {launches}")
    if r["n_images"] != 16 or r["batch_size"] != EVAL_B:
        raise AssertionError(f"expected 16 images at batch {EVAL_B}: {r}")
    for key in ("jaccard_mean", "f1_mean"):
        if not 0.0 <= r[key] <= 1.0:
            raise AssertionError(f"{key} out of [0, 1]: {r[key]}")
    per_forward = {n: c / forwards for n, c in launches.items()}
    if not (per_forward["correlation_fusion"] >= 1
            and per_forward["fused_attention"] >= 2
            and per_forward["relu_instancenorm"] == 27
            and per_forward["correlation_fusion_bwd"] == 0
            and per_forward["fused_attention_bwd"] == 0):
        raise AssertionError(f"kernel launches per forward: {per_forward}")

    rest = timed["batch_seconds"][1:]
    med = statistics.median(rest)
    log(f"  timed: {timed['n_images']} images, {len(rest)} batches of {EVAL_B} after "
        f"one warm-up; batch seconds median {med:.4f} (min {min(rest):.4f}, "
        f"max {max(rest):.4f}); images/s {EVAL_B / med:.3f} (from the min "
        f"{EVAL_B / max(rest):.3f}, from the max {EVAL_B / min(rest):.3f})")
    if timed["n_images"] != TIMED_SET // 5 or len(rest) < 5:
        raise AssertionError(f"timed run: {timed['n_images']} images, "
                             f"{len(rest)} timed batches")
    return launches


def phase_train_slice(ops, tmp):
    """The training CLI at full width for one epoch of 8 steps, validation
    by checkpoint and the test; launch counters reset just before and read
    just after. Returns the launch counts of the run."""
    from corrifnet_tpu_torch.run.main import main as train_main

    cfg = write_run_inputs(TRAIN_SET, tmp, "train.json", n_epochs=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    r = train_main(["--config", str(cfg), "--run-root", str(tmp), "--device", "cuda"])
    launches = read_counts(ops)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    steps = r["train_steps"]
    evals = 1 + 2  # 3 validation patches: 1 batch; 8 test patches: 2 batches
    want = {"correlation_fusion": steps + evals, "correlation_fusion_bwd": steps,
            "fused_attention": 4 * (steps + evals), "fused_attention_bwd": 4 * steps,
            "relu_instancenorm": 27 * (steps + evals)}
    log(f"  {steps} training steps, {evals} evaluation batches in {wall:.2f} s; "
        f"launches {launches}")
    log(f"  per training step: K1f 1, K1b {launches['correlation_fusion_bwd'] / steps:g}, "
        f"K2f 4, K2b {launches['fused_attention_bwd'] / steps:g}, K3 27 "
        f"(forward-only batches launch K1f 1, K2f 4, K3 27 each)")
    if steps != 8 or launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")

    run_dir = Path(r["run_dir"])
    files = ["lrFile.txt", "trainFile.txt", "trainaccFile.txt", "trainepochFile.txt",
             "valFile.txt", "valaccFile.txt", "testFile.txt", "testaccFile.txt",
             "fpsfile.txt", "iremmodel0", "Finaliremmodel0"]
    missing = [f for f in files if not (run_dir / f).exists()
               or (run_dir / f).stat().st_size == 0]
    if missing:
        raise AssertionError(f"run directory lacks {missing}")
    h = r["history"]
    losses = {"train": h["train_loss"][0], "validation": h["val_loss"][0],
              "test": r["test_loss"]}
    jaccards = {"train": h["train_jac"][0], "validation": h["val_jac"][0],
                "test": r["test_jaccard"]}
    log(f"  losses {losses}; jaccards {jaccards}; test FPS {r['fps']:.3f}")
    for what, value in losses.items():
        if not 0.5 <= value <= 1.0:
            raise AssertionError(f"{what} loss {value} outside the double-sigmoid "
                                 f"band 0.5-1.0")
    for what, value in jaccards.items():
        if not (np.isfinite(value) and 0.0 <= value <= 1.0):
            raise AssertionError(f"{what} jaccard {value}")

    rest = h["step_seconds"][2:]
    med = statistics.median(rest)
    log(f"  step seconds after the first two steps ({len(rest)} steps, the last "
        f"one a padded batch): median {med:.4f} (min {min(rest):.4f}, max "
        f"{max(rest):.4f}); patches/s {TRAIN_B / med:.3f} (from the max "
        f"{TRAIN_B / max(rest):.3f}, from the min {TRAIN_B / min(rest):.3f}); peak "
        f"memory allocated {peak} bytes ({peak / 2 ** 30:.3f} GiB)")
    return launches


def seeded_image():
    return torch.randn((1, 3, 3, 224, 224), generator=torch.Generator().manual_seed(0))


def phase_whole_model():
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.testing import calibrate_batchnorm

    x = seeded_image()
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


def step_gradients(model, x, masks, valid):
    """(loss, {name: gradient on the CPU}) of one training-mode step."""
    from corrifnet_tpu_torch.train import masked_loss_and_jaccard

    dev = next(model.parameters()).device
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(x.to(dev)).float()
    loss, _, _ = masked_loss_and_jaccard(out, masks.to(dev), valid.to(dev))
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                         if p.grad is not None}


def gradient_agreement(got, want):
    """||got - want|| / ||want|| over the whole gradient, its median over
    the tensors and its (worst, name) among them."""
    diff = sum((got[n] - want[n]).square().sum().item() for n in want)
    norm = sum(want[n].square().sum().item() for n in want)
    l2 = [(((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)).item(), n)
          for n in want]
    return (diff / norm) ** 0.5, statistics.median(v for v, _ in l2), max(l2)


def phase_train_step():
    """One f32 training step at B=1 without dropout, BatchNorm on batch
    statistics: the loss and every gradient tensor on the card (kernels,
    forward and backward) against the CPU (plain versions), same weights
    and input.

    At random initialization the gradient of this network is badly
    conditioned: some forty normalization layers in sequence amplify f32
    rounding, so that both the card's and the CPU's gradient tensors sit 3
    to 6 percent of their norm away from the gradient computed in f64
    (measured once, with the plain versions in f64 on both devices, which
    agree with each other to 3e-12). The yardstick is therefore measured in
    the run: the witness, the CPU against itself with the input scaled by
    1 + 1e-6. The loss is held to 1e-5; every gradient tensor's
    ||GPU - CPU|| / ||CPU|| to twice the witness's worst tensor, and the
    whole gradient's to twice the witness's. A backward that is wrong in
    one branch fails this: the skip gradients that the library's
    nearest-resize backward got wrong on the card (see nn/resize.py) read
    0.49 against a bound near 0.12. The kernels' own backward checks
    (phase 3) are the tight ones."""
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.testing import calibrate_batchnorm

    x = seeded_image()
    gen = torch.Generator().manual_seed(1)
    masks = (torch.rand((1, 3, 1, 224, 224), generator=gen) > 0.5).float()
    valid = torch.ones(1)
    cpu = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=0,
                       transformer_dropout=0.0)
    calibrate_batchnorm(cpu, x)
    gpu = copy.deepcopy(cpu).to("cuda")
    witness = copy.deepcopy(cpu)
    loss_gpu, g_gpu = step_gradients(gpu, x, masks, valid)
    loss_cpu, g_cpu = step_gradients(cpu, x, masks, valid)
    _, g_wit = step_gradients(witness, x * (1 + 1e-6), masks, valid)
    if sorted(g_gpu) != sorted(g_cpu):
        raise AssertionError("gradients exist for different parameters on GPU and CPU")
    whole, med, worst = gradient_agreement(g_gpu, g_cpu)
    w_whole, w_med, w_worst = gradient_agreement(g_wit, g_cpu)
    bound_whole, bound_tensor = STEP_WITNESS_FACTOR * w_whole, STEP_WITNESS_FACTOR * w_worst[0]
    log(f"  witness, CPU against CPU with the input scaled by 1 + 1e-6, relative L2: "
        f"whole gradient {w_whole:.3e}; per tensor median {w_med:.3e}, worst "
        f"{w_worst[0]:.3e} at {w_worst[1]}")
    log(f"  loss GPU {loss_gpu:.8f} CPU {loss_cpu:.8f} (bound {STEP_LOSS_ATOL}); "
        f"{len(g_cpu)} gradient tensors, ||GPU - CPU|| / ||CPU||: whole gradient "
        f"{whole:.3e} (bound {bound_whole:.3e}); per tensor median {med:.3e}, worst "
        f"{worst[0]:.3e} at {worst[1]} (bound {bound_tensor:.3e}, "
        f"{STEP_WITNESS_FACTOR} times the witness's)")
    if not (abs(loss_gpu - loss_cpu) <= STEP_LOSS_ATOL and whole <= bound_whole
            and worst[0] <= bound_tensor):
        raise AssertionError("training step GPU vs CPU outside its bounds")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # before any output: run without the package, the script prints nothing
    from corrifnet_tpu_torch import ops
    from corrifnet_tpu_torch.ops.build import BUILD_DIR, load_cuda_library

    started = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        list(pool.map(load_cuda_library, CUDA_SOURCES))  # one nvcc each, together
    log(f"  nvcc build + load of 2 sources {time.perf_counter() - t0:.2f} s")
    for report in sorted(BUILD_DIR.glob("*.log")):
        summary = [ln for ln in report.read_text().splitlines()
                   if "registers" in ln or "spill" in ln]
        log(f"  {report.name}: " + " | ".join(s.strip() for s in summary))

    log("phase 3: kernels against their plain versions")
    t0 = time.perf_counter()
    results = phase_kernels(ops)
    log(f"  phase 3 took {time.perf_counter() - t0:.2f} s (Triton compiles included)")

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            log("phase 4: evaluation slice, 16 images, B=8, bf16")
            phase_eval_slice(ops, tmp)
            log("phase 5: training slice, 40 patches, 1 epoch, B=4, bf16, dropout 0.1")
            launches = phase_train_slice(ops, tmp)
        finally:
            os.chdir(here)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    log("phase 6: whole model, B=1 f32, GPU kernels vs CPU plain versions")
    phase_whole_model()
    log("phase 7: one training step, B=1 f32, GPU kernels vs CPU plain versions")
    phase_train_step()
    torch.cuda.synchronize()
    log(f"chip_smoke took {time.perf_counter() - started:.1f} s")

    kernels = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **results[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
