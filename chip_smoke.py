#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (corrifnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result lines):

1. device: exit 1 when torch.cuda.is_available() is False; print the
   card's name and power limit as nvidia-smi gives them;
2. build: compile the five CUDA C++ sources with nvcc (in parallel) and load
   them; ptxas's registers and spills of every kernel are printed, and the
   HGMMA (wgmma) instructions of every bf16 tensor-core kernel in the SASS
   (``cuobjdump -sass``), none of which may have none;
3. kernels: each kernel against its plain PyTorch version on the card,
   first in f32 (TF32 off), then in bf16 against the plain version run in
   f32 on the same bf16 inputs; errors, bounds and median CUDA-event times
   of the kernel, the plain version and, where one PyTorch call computes the
   same function, that call. Every kernel is reached as the paths reach
   it: the forward kernels at the evaluation shapes (B=8) through their
   wrappers with no gradient asked for (K2f without the logsumexp), then all five
   at the training shapes (B=4) through the wrappers on leaves that need
   gradients and ``backward``: K1f, K1b, K2f with dropout 0.1 and the
   logsumexp, K2b at rate 0 and 0.1, K3 and K3b (its backward, on the
   statistics K3 saved; two runs and runs queued on two streams give the
   same bits; both with their device time, the library's and the bound,
   the library being ``F.instance_norm(F.relu(x))`` on NCDHW, its backward
   through ``autograd.grad``). With dropout on, the plain
   version gets the kernels' Philox mask and the comparison is element by
   element; the mask each of the kernels' three device functions writes is
   held against ``philox_keep_mask`` exactly. K2f and K2b are reached as
   the model reaches them, through ``fused_attention_qkv`` on the
   (B, N, 3, H, 64) projection with the cotangent in (B, N, H, 64) memory,
   so on strided views; the plain versions and SDPA get the same views. In
   bf16 they are the tensor-core kernels: per shape they are held against
   the plain version that rounds p and ds to bf16 where they do (2 bf16 ulps
   of the largest entry) and against pure f32 (2e-2), timed at rate 0 and at
   rate 0.1 with SDPA's time at the same rate (its own dropout; at rate 0.1
   also at rate 0), the bound and the achieved TFLOP/s beside (the
   backward also with the host's share of one launch), and the device time of
   the kernels' and SDPA's calls from profiler traces (the forward at B=8, the
   forward and the backward through ``autograd.grad`` at B=4, on the same
   views), summed over one forward or step; at every shape the
   calls on the views must equal the calls on contiguous copies bit for bit,
   the packed entry ``fused_attention_qkv`` the unpacked one, and two
   backward runs each other. The fused bottleneck convolutions K4a-K4d
   run at every shape the three encoders give them at B=4 (16 pointwise
   shapes, 4 3x3 shapes), through their ``autograd.Function`` with non-zero
   cotangents for y, s and q, in f32 and bf16; two runs must give the same
   bits, and the evaluation variant without statistics the same y (that
   variant is also timed at the B=8 shapes); their
   library yardstick is ``F.linear``/``F.conv2d`` with the BatchNorm apply,
   ReLU and statistics in tensor ops. In bf16 all four are the tensor-core
   kernels: per shape, for the forwards at B=8 without the statistics and
   at B=4 with them, for the backwards (K4b, K4d, called on the forward's
   saved tensors) at B=4, the kernel's and the library composition's device
   time (the kernels of 20 calls in a ``torch.profiler`` trace; the
   library's backward through ``autograd.grad``), their ratio, TFLOP/s and
   the share of the bound, and the sums over one forward or step. Then the
   shapes MMVit2 and mmformer add, as above: K2f and K2b with the
   multimodal transformer at N=1536 (B=8 forward; B=4 forward and backward
   at rate 0 and 0.1; the keep masks at n=1536), K3 and K3b at the conv
   encoders' and the larger RFM volumes (the plan's regime printed with
   each);
4. the evaluation slice: ``run.evaluate.main`` over 16 synthetic 224x224
   images at batch 8 in bf16, with every launch counter reset just before
   and read just after (K1 1, K2 4, K3 27, K3b 0 launches per
   forward: at B=8 the decoder's chain is the fused standard one); then over
   48 images, timed;
5. the training slice: ``run.main.main`` at full width (MMVit4, 224x224,
   B=4, bf16, dropout 0.1) for one epoch of 8 steps over 40 synthetic
   patches, with validation by checkpoint and the test, the default
   program: the data set resident on the card as bf16 images and uint8
   masks (its bytes are checked); counters reset just
   before and read just after: per training step K1f 1, K1b 1, K2f 4, K2b 4
   (its dq and dk/dv passes count as one launch), K3 15, K3b 15 (at B=4
   the decoder is lean, by the JAX package's batch rule: K3 ends the 15 RFM
   blocks, the 12 chain stages end in ``relu_in_stats``); the log
   files, both checkpoints and the segplot PNGs exist (the curve PNGs too
   where matplotlib is installed); losses in the double-sigmoid band;
   step seconds, patches/s and peak memory are printed;
6. whole model: one image (B=1) in f32 with TF32 off, through the kernels
   on the card and through the plain versions on the CPU, same weights:
   max |difference| of the probabilities <= 1e-4;
7. one training step (B=1, f32, TF32 off, dropout 0) on the card against
   the CPU: the loss within 1e-5, and every gradient tensor's relative L2
   distance within twice the worst that the CPU shows against itself
   when the input changes by one part in 10^6 (measured in the run); with
   the lean decoder (the batch rule at B=1), then with
   ``decoder_lean=False`` (the fused standard chain);
8. the fused configuration (``"pallas_fused_blocks": true``): phases 4 and 5
   again through the same entry points, at the same sizes: per forward K4a
   108 and K4c 39 launches, per training step K4b 108 and K4d 39 more, K1-K3
   as with the flag off; images/s, step seconds, patches/s and peak memory
   are printed beside the flag-off numbers of this run;
9. fused, card against CPU in f32: one train step of a full-width
   ``Bottleneck3D(pallas_fused=True)`` (output, running statistics,
   gradients; 1e-4 of each tensor's largest entry) for the three kinds of
   block, and the whole model of phase 6 with the flag on (1e-4);
10. the decoder (``phase_decoder``): at the cascade's real sizes in f32,
   depth-fused against the plain chain, lean against standard, the fused
   lean decoder on the card against the CPU (bounds in its docstring); then
   the device time and peak memory of the decoder's forward and backward at
   B=4 in bf16, for the plain chain and the fused chain with lean off and
   on;
11. the training entry point's run-level features (``phase_run_level``),
   phase 5's configuration for two epochs with extended checkpoints, every
   run through ``run.main.main``: ``--indices 0,1`` over a ``{i}`` config
   template (two identical runs, the data resident: their largest
   difference over the final checkpoint's tensors and the log files' values
   is the witness, which must be 0); the same streamed
   (``CORRIFNET_DEVICE_DATA=0``), within twice the witness (equal bits),
   with step seconds, patches/s and peak memory beside the resident run's;
   ``--train-deadline-s 0.001`` (one epoch, tested, ``state0@8`` written),
   then ``--resume`` to the second epoch (the log files continued, equal
   bits, the launches per step of phase 5 counted around the resumed run);
   a ``transfertype: yestr`` warm
   start from the first run's ``Finaliremmodel0``. Phase 11 runs after
   phase 8, in its directory;
12. the conv-encoder family (``phase_conv_family``), MMVit2 then mmformer:
   (a) ``run.evaluate.main`` over 16 images at B=8 in bf16 with the
   counters reset just before and read just after (per forward K1f 1 /
   0, K2f 4, K3 69, K3b 0, K4 0), then 48 timed; (b) ``run.main.main`` at
   B=4, bf16, dropout 0.1, 40 patches resident, one epoch (per step K1f
   and K1b 1 / 0, K2f and K2b 4, K3 and K3b 57), the run directory, the
   losses' band, step seconds, patches/s, images/s and peak memory; (c)
   phase 6 and (d) phase 7 for the model, the whole-model bound being the
   larger of 1e-4 and twice the CPU's own change under a 1e-6 change of
   the input, and a gradient tensor outside phase 7's bound held against
   the same step in float64 on the card (see ``phase_train_step``); the
   training run is ``--indices 0,1``: two identical runs, equal bit for bit;
13. RFNet, then RobustMseg (``phase_zoo``), as phase 12: (a) evaluation with
   no kernel launched; (b) ``--indices 0,1`` training at B=4, bf16, 40
   patches resident, no kernel launched, the two runs equal bit for bit;
   (c) and (d) card against CPU, the CPU's convolutions PyTorch's own in
   (d) (oneDNN's conv3d weight gradient sums RFNet's 128^3 volumes less
   accurately), RFNet's conv biases (which feed an InstanceNorm: their
   gradient is 0 but for rounding) held by size, RobustMseg's Dropout2d
   given the same host-drawn masks on both devices.

Every training run of phases 5, 8, 11, 12 and 13 runs under the entry
point's ``deterministic()`` scope (PyTorch's deterministic algorithms,
cuDNN's deterministic algorithms without benchmarking), so that an op
without a deterministic implementation raises; phase 3's timings run
outside it, as a caller's code would.

Then one JSON line of kernel results, the card line again, and last the
device line ``{"ok": true, "device": {...}}``. Imports no jax.

``bound_ms`` is the least time the card could take: the larger of the
bytes the function must move (each input read once, each output written
once) over the H100 SXM's 3.35 TB/s and its operations over 989 TFLOP/s
(dense bf16 tensor rate), both from NVIDIA's data sheet.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import importlib.util
import json
import os
import re
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
    "relu_instancenorm": ("cuda", "corrifnet_tpu_torch/csrc/instancenorm.cu",
                          "corrifnet_tpu/ops/instancenorm.py:67"),
    # the port's own backward: it stands for XLA's fusion of _vjp_bwd
    "relu_instancenorm_bwd": ("cuda", "corrifnet_tpu_torch/csrc/instancenorm.cu",
                              "corrifnet_tpu/ops/instancenorm.py:142"),
    "pointwise_conv_stats": ("cuda", "corrifnet_tpu_torch/csrc/fusedconv_pw.cu",
                             "corrifnet_tpu/ops/fusedconv.py:142"),
    "pointwise_conv_stats_bwd": ("cuda", "corrifnet_tpu_torch/csrc/fusedconv_pw.cu",
                                 "corrifnet_tpu/ops/fusedconv.py:211"),
    "conv3x3_fma_relu_stats": ("cuda", "corrifnet_tpu_torch/csrc/fusedconv_c3.cu",
                               "corrifnet_tpu/ops/fusedconv.py:418"),
    "conv3x3_fma_relu_stats_bwd": ("cuda", "corrifnet_tpu_torch/csrc/fusedconv_c3.cu",
                                   "corrifnet_tpu/ops/fusedconv.py:514"),
}
# the kernels only the fused configuration launches
K4_KERNELS = ("pointwise_conv_stats", "pointwise_conv_stats_bwd",
              "conv3x3_fma_relu_stats", "conv3x3_fma_relu_stats_bwd")
CUDA_SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "fusedconv_pw.cu",
                "fusedconv_c3.cu", "instancenorm.cu")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core rate, same sheet
EVAL_B = 8   # per_image_metrics batch: max(mini_batch_size=4, 8)
TRAIN_B = 4  # mini_batch_size


def k1_shape(b):
    return (3, b, 512, 512)


def k2_shapes(b, model="MMVit4"):
    """(shape, launches per forward) of the two attention shapes: three
    IntraFormers at N=512 and the multimodal transformer over 4 token groups
    (MMVit4) or 3 (MMVit2 and mmformer)."""
    return [((b, 8, 512, 64), 3), ((b, 8, 512 * (4 if model == "MMVit4" else 3), 64), 1)]


def k3_shapes(b, chain=True):
    """(shape, launches per forward) of the decoder epilogues K3 ends: the 15
    RFM blocks', and with ``chain`` the 12 chain stages' (where the decoder
    is not lean: batch > 4 by default)."""
    rfm = [((b, 8, 8, 8, 192), 3), ((b, 3, 14, 14, 192), 3), ((b, 3, 28, 28, 96), 3),
           ((b, 3, 56, 56, 48), 3), ((b, 3, 56, 56, 24), 3)]
    return rfm + ([((b, 16, 16, 16, 128), 1), ((b, 16, 16, 16, 64), 2),
                   ((b, 32, 32, 32, 32), 3), ((b, 64, 64, 64, 16), 3),
                   ((b, 128, 128, 128, 8), 3)] if chain else [])


ENCODERS = 3
# K3 calls per forward: the RFM blocks', and the chain's where lean is off
K3_LEAN, K3_STANDARD = 15, 27


def k3_encoder_shapes(b):
    """(shape, launches per forward) of the K3 calls of MMVit2's and
    mmformer's three conv encoders: 14 GeneralConv3d each."""
    return [((b, 3, 224, 224, 8), 2 * ENCODERS), ((b, 2, 112, 112, 16), 3 * ENCODERS),
            ((b, 1, 56, 56, 32), 3 * ENCODERS), ((b, 1, 28, 28, 64), 3 * ENCODERS),
            ((b, 1, 14, 14, 64), 3 * ENCODERS)]


def k3_conv_family_shapes(b, chain=True):
    """(shape, launches per forward) of MMVit2's and mmformer's K3 calls: the
    encoders', the RFM blocks' on the stacked skips (depths 3/2/1/1 at
    224/112/56/28), and with ``chain`` the decoder chain's (as MMVit4's)."""
    rfm = [((b, 8, 8, 8, 192), 3), ((b, 1, 28, 28, 192), 3), ((b, 1, 56, 56, 96), 3),
           ((b, 2, 112, 112, 48), 3), ((b, 3, 224, 224, 24), 3)]
    return k3_encoder_shapes(b) + rfm + (k3_shapes(b)[5:] if chain else [])


# launches per forward of each model: K1f, K2f, and K3 at B=8 (the standard
# chain) and at B=4 (lean: the chain's 12 stages end in relu_in_stats)
MODEL_LAUNCHES = {
    "MMVit4": {"k1": 1, "k2": 4, "k3_eval": K3_STANDARD, "k3_step": K3_LEAN},
    "MMVit2": {"k1": 1, "k2": 4, "k3_eval": 69, "k3_step": 57},
    "mmformer": {"k1": 0, "k2": 4, "k3_eval": 69, "k3_step": 57},
    # the JAX package runs no Pallas kernel on these two
    "RFNet": {"k1": 0, "k2": 0, "k3_eval": 0, "k3_step": 0},
    "RobustMseg": {"k1": 0, "k2": 0, "k3_eval": 0, "k3_step": 0},
}
# a gradient that is 0 but for rounding, by model: RFNet's conv biases feed an
# InstanceNorm, which takes their mean out; held by size (ZERO_NOISE of the
# largest gradient entry), not against the witness
ZERO_GRADIENT = {"RFNet": ".conv.bias"}
ZERO_NOISE = 1e-5


K4_PER_FORWARD = {"pointwise_conv_stats": 108, "conv3x3_fma_relu_stats": 39}


def k4_pointwise_shapes(b):
    """(rows, ci, co, prologue, calls per encoder) of the 36 fused 1x1 convs of
    one encoder: conv1 (no prologue), conv3 (prologue) and the projection of
    each first block (no prologue, on the subsampled input)."""
    r = [3 * b * side * side for side in (56, 28, 14, 7)]  # depth 3 in the batch
    return [
        (r[0], 64, 64, False, 1), (r[0], 64, 256, True, 3), (r[0], 64, 256, False, 1),
        (r[0], 256, 64, False, 2), (r[0], 256, 128, False, 1),
        (r[1], 128, 512, True, 4), (r[1], 256, 512, False, 1),
        (r[1], 512, 128, False, 3), (r[1], 512, 256, False, 1),
        (r[2], 256, 1024, True, 6), (r[2], 512, 1024, False, 1),
        (r[2], 1024, 256, False, 5), (r[2], 1024, 512, False, 1),
        (r[3], 512, 2048, True, 3), (r[3], 1024, 2048, False, 1),
        (r[3], 2048, 512, False, 2),
    ]


def k4_conv_shapes(b):
    """(x shape, calls per encoder) of the 13 fused stride-1 3x3 convs."""
    return [((3 * b, 56, 56, 64), 3), ((3 * b, 28, 28, 128), 3),
            ((3 * b, 14, 14, 256), 5), ((3 * b, 7, 7, 512), 2)]


# f32 bounds against the plain version: sums in another order
K1_ATOL = 1e-6
K2_ATOL = 2e-5
K3_ATOL, K3_RTOL = 1e-5, 1e-4
# K2 gradients: 2e-5 of the largest gradient (N-long sums of products)
K2_GRAD_RTOL = 2e-5
# bf16 bounds of K2 against pure f32 on the same bf16 inputs: inputs rounded
# to bf16 meet in 2048-long sums, p and ds are rounded to bf16 between the
# two products (as in the TPU kernel) and the outputs are rounded to bf16, so
# 2e-2 absolute on the output (values O(1)) and 2e-2 of the largest gradient
K2_BF16_ATOL = 2e-2
K2_BF16_GRAD_RTOL = 2e-2
# bf16 K2 against the plain version that rounds p (forward) and p m, ds
# (backward) to bf16 as the kernels do: 2 bf16 ulps of the reference's largest
# entry. The kernel rounds exp(s - running max), the plain version exp(s -
# final max), and both feed up to 2048-long f32 sums taken in another order,
# so a result can fall on the other side of a rounding boundary; measured
# 0.5 to 1 ulp of the largest entry at every shape and rate
K2_ROUNDING_ULPS = 2.0
# K4: max |kernel - plain| over max |plain|, per output. f32: sums of up to
# 37,632 rows or 9 x 512 channels in another order. bf16: the plain version
# rounds at the same points with f32 accumulation, so values differ by one
# bf16 ulp where a sum lands on the other side of a rounding boundary; the
# f32 statistics see the same rounded inputs
K4_F32, K4_BF16, K4_BF16_STATS = 2e-5, 1e-2, 1e-4
# a fused bottleneck's train step, card against CPU, of each tensor's largest entry
FUSED_BLOCK_RTOL = 1e-4
WHOLE_MODEL_ATOL = 1e-4
# one f32 training step, card against CPU: the loss, and the gradients'
# relative L2 distance as a multiple of what the CPU shows against itself
# under a 1e-6 change of the input (see phase_train_step)
STEP_LOSS_ATOL, STEP_WITNESS_FACTOR = 1e-5, 2.0
# lean against standard decoder gradients, of each tensor's largest entry
LEAN_GRAD_RTOL = 2e-5
SCALE = 0.125
RATE = 0.1
PHILOX = (20260, 17)
# the timed evaluation: fold 2 of 5 of 240 patches is 48 images, 6 batches of 8
TIMED_SET = 240
TRAIN_SET = 40  # 29 training patches (8 steps of 4), 3 validation, 8 test
TRAIN_EVALS = 1 + 2  # 3 validation patches: 1 batch; 8 test patches: 2 batches
# the training set resident on the card, wire-cast: bf16 images, uint8 masks
RESIDENT_BYTES = TRAIN_SET * (3 * 3 * 224 * 224 * 2 + 3 * 1 * 224 * 224)
# the per-epoch log files beside lrFile.txt
LOG_FILES = ("trainFile.txt", "trainaccFile.txt", "trainepochFile.txt", "valFile.txt",
             "valaccFile.txt", "testFile.txt", "testaccFile.txt")


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_name(mangled):
    """'name<template arguments>' from an Itanium-mangled kernel symbol: the
    last ``<length><name>`` whose name ends in ``_kernel``, with the ``I...E``
    that follows it when it is a template."""
    found = mangled
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):
            size = int(mangled[start:m.end()])
            name = mangled[m.end():m.end() + size]
            if len(name) == size and re.fullmatch(r"[a-z][a-z0-9_]*_kernel", name):
                rest = mangled[m.end() + size:]
                args = rest[1:rest.index("Ev")].rstrip("E") if rest.startswith("I") else ""
                found = f"{name}<{args}>" if args else name
    return found


def ptxas_summary(report):
    """'kernel: N registers, S bytes of spill stores' for each kernel of one
    ``nvcc -Xptxas -v`` report."""
    out, name, spills = [], None, "?"
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name, spills = kernel_name(ln.split("'")[1]), "?"
        elif "spill stores" in ln:
            spills = ln.split("bytes stack frame,")[1].split("bytes spill stores")[0].strip()
        elif "Used" in ln and "registers" in ln and name is not None:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers, {spills} bytes of spill stores")
            name = None
    return out


def hgmma_counts(library):
    """{kernel: number of HGMMA (wgmma) instructions} in the SASS of one
    built library, by ``cuobjdump -sass``."""
    from corrifnet_tpu_torch.ops.build import nvcc_path

    sass = subprocess.run([str(Path(nvcc_path()).parent / "cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_name(ln.split("Function :")[1].strip())
            counts[name] = 0
        elif name is not None and "HGMMA" in ln:
            counts[name] += 1
    return counts


def check_tensor_core_kernels(build_dir):
    """Every instantiation of the bf16 tensor-core kernels holds wgmma
    instructions: the fused conv forwards and the backwards' dx passes
    (conv_wgmma_kernel, 12 each), the backwards' dw passes
    (wgrad_wgmma_kernel, 4) and the attention kernels."""
    found = {}
    for lib in sorted(build_dir.glob("lib*.so")):
        counts = hgmma_counts(lib)
        wg = {k: v for k, v in counts.items() if "wgmma" in k}
        log(f"  {lib.name}: HGMMA in the SASS: " + (
            "; ".join(f"{k} {v}" for k, v in wg.items()) or "none"))
        found.update(wg)
    conv = [k for k in found if k.startswith("conv_wgmma_kernel")]
    wgrad = [k for k in found if k.startswith("wgrad_wgmma_kernel")]
    if len(conv) < 24 or len(wgrad) < 4 or not all(found.values()):
        raise AssertionError(f"tensor-core kernels without HGMMA: {found}")


def device_ms(fn, launches=20):
    """A kernel's time on the card: ``launches`` calls queued between one pair
    of events, so that the host's dispatch of one hides behind the run of
    the one before (where a run is shorter than a dispatch this still reads
    the dispatch)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def profiled_device_ms(fn, launches=20, by_kernel=False):
    """The device time of one call of ``fn``: the kernels (and copies) that
    ``launches`` calls run, summed from a ``torch.profiler`` trace of them,
    over the count (``by_kernel``: {kernel name: ms per call}). Unlike
    ``device_ms`` it does not read the host's dispatch where that is longer
    than the kernels. A trace now and then loses kernels, so a time is
    taken only when two traces hold the same number of kernels, at least
    one a call; after five traces without that, from the trace with the
    most kernels (or, with fewer than one a call, by ``device_ms``, under
    the name "all, by events"), and a line says so."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    # host and device activity, as the profile scripts trace it: a trace of
    # the device alone now and then came back with kernels missing
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def per_call(kernels):
        ms = {}
        for e in kernels:
            ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / launches
        return ms if by_kernel else sum(ms.values())

    seen = {}  # kernels in a trace: its times
    for _ in range(5):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(kernels) >= launches and len(kernels) in seen:
            return per_call(kernels)
        seen[len(kernels)] = per_call(kernels)
    most = max(seen)
    if most >= launches:
        log(f"  (no two of five traces held as many kernels: {sorted(seen)}; this "
            f"time is from the one with the most)")
        return seen[most]
    log("  (the profiler missed kernels in five traces: this time is by events)")
    ms = device_ms(fn, launches)
    return {"all, by events": ms} if by_kernel else ms


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


def ulps_of_max(got, ref):
    """max |got - ref| in bf16 ulps of ref's largest entry."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / bf16_ulp(ref.abs().max())).item()


def randn(shape, gen, shift=0.0):
    return torch.randn(shape, generator=gen, device="cuda") + shift


class Tally:
    """Per-kernel sums over the calls of one forward or one training step."""

    def __init__(self):
        self.rows, self.failures, self.bound_kinds = {}, [], {}
        # name: [kernel, library, bound] device ms, summed
        self.device = {}

    def add_device(self, name, calls, ms, library_ms, bound_ms):
        sums = self.device.setdefault(name, [0.0, 0.0, 0.0])
        for i, v in enumerate((ms, library_ms, bound_ms)):
            sums[i] += calls * v

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
        for name, (ms, lib, bound) in self.device.items():
            log(f"  {title} {name}, device time (profiler, 20 calls a shape): "
                f"kernel {ms:.4f} ms, library {lib:.4f} ms, kernel / library "
                f"{ms / lib:.2f}, bound {bound:.4f} ms, {bound / ms:.1%} of the bound")


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


def k3_streams(fn, lone, calls=4):
    """``calls`` runs of ``fn`` queued on each of two streams at once, each
    result against the lone call's bits (the grid barrier's counters are
    one pair a stream)."""
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(calls):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(fn())
    torch.cuda.synchronize()
    return all(torch.equal(o, lone) for o in outs)


def check_instancenorm(ops, tally, b, gen, backward, shapes=None):
    """K3 at every decoder shape (or at ``shapes``: (shape, calls) pairs;
    and with ``backward`` K3b, on the
    statistics K3 saved) against the plain versions: f32 within K3_ATOL +
    K3_RTOL rel, bf16 within 2 bf16 ulps of the plain version run in f32 on
    the same inputs plus the f32 bound; two runs and runs queued on two
    streams give the same bits. Times in bf16: the call (median of single
    calls: K3 with no gradient asked for, K3b through ``autograd.grad``),
    the plain version and the library's ``F.instance_norm(F.relu(x))`` on
    the NCDHW layout (its backward through ``autograd.grad``), and both
    device times from profiler traces."""
    from corrifnet_tpu_torch.ops import instancenorm as t_in

    # the training step at B=4 runs the lean decoder: K3 ends the RFMs only
    for shape, calls in shapes or k3_shapes(b, chain=not backward):
        x = randn(shape, gen, 0.2)
        x16 = x.bfloat16()
        name = "relu_instancenorm"
        got, want = ops.relu_instancenorm(x), ops.relu_instancenorm_plain(x)
        err = (got - want).abs()
        tally.check((err <= K3_ATOL + K3_RTOL * want.abs()).all(),
                    f"{name} {shape} f32 {err.max().item():.3e}")
        ref = ops.relu_instancenorm_plain(x16.float())
        y16 = ops.relu_instancenorm(x16)
        e16 = (y16.float() - ref).abs()
        tally.check((e16 <= 2 * bf16_ulp(ref) + K3_ATOL + K3_RTOL * ref.abs()).all(),
                    f"{name} {shape} bf16")
        same = torch.equal(ops.relu_instancenorm(x16), y16) and k3_streams(
            lambda: ops.relu_instancenorm(x16), y16)
        tally.check(same, f"{name} {shape}: runs differ")
        del ref, got, want
        ncdhw = x16.permute(0, 4, 1, 2, 3).contiguous()
        with torch.no_grad():
            k_ms = median_ms(lambda: ops.relu_instancenorm(x16))
            p_ms = median_ms(lambda: ops.relu_instancenorm_plain(x16))
            l_ms = median_ms(lambda: F.instance_norm(F.relu(ncdhw)))
            k_dev = profiled_device_ms(lambda: ops.relu_instancenorm(x16))
            l_dev = profiled_device_ms(lambda: F.instance_norm(F.relu(ncdhw)))
        bound = bytes_bound_ms(2 * x.numel())
        regime = t_in.plan(shape[0], x[0, ..., 0].numel(), shape[-1], 2,
                           max_blocks=t_in._max_blocks(x.device)).regime
        log(f"  {name} {shape} x{calls} ({regime}): f32 max_abs {err.max().item():.3e} (bound "
            f"{K3_ATOL} + {K3_RTOL} rel); bf16 max_abs {e16.max().item():.3e} (bound 2 bf16 "
            f"ulps + the f32 bound); repeatable, also on two streams: {same}; bf16 call "
            f"kernel {k_ms:.4f} plain {p_ms:.4f} library {l_ms:.4f} ms; device (profiler, 20 "
            f"calls) kernel {k_dev:.4f} library {l_dev:.4f} bound {bound:.4f} ms, "
            f"{bound / k_dev:.1%} of the bound")
        tally.add(name, calls, e16.max().item(), k_ms, p_ms, bound, "bytes", l_ms)
        tally.add_device(name, calls, k_dev, l_dev, bound)
        if not backward:
            continue

        name = "relu_instancenorm_bwd"
        g = randn(shape, gen)
        g16 = g.bfloat16()
        _, mean, rstd = t_in._launch(x, 1e-5)
        got = ops.relu_instancenorm_bwd(x, g, mean, rstd)
        want = ops.relu_instancenorm_backward_plain(x, g)
        err = (got - want).abs()
        tally.check((err <= K3_ATOL + K3_RTOL * want.abs()).all(),
                    f"{name} {shape} f32 {err.max().item():.3e}")
        leaf = x16.clone().requires_grad_()
        out16 = ops.relu_instancenorm(leaf)
        d16 = torch.autograd.grad(out16, leaf, g16, retain_graph=True)[0]
        ref = ops.relu_instancenorm_backward_plain(x16.float(), g16.float())
        e16 = (d16.float() - ref).abs()
        tally.check((e16 <= 2 * bf16_ulp(ref) + K3_ATOL + K3_RTOL * ref.abs()).all(),
                    f"{name} {shape} bf16")
        _, mean16, rstd16 = t_in._launch(x16, 1e-5)
        direct = ops.relu_instancenorm_bwd(x16, g16, mean16, rstd16)
        same = (torch.equal(direct, d16)
                and torch.equal(ops.relu_instancenorm_bwd(x16, g16, mean16, rstd16), d16)
                and k3_streams(lambda: ops.relu_instancenorm_bwd(x16, g16, mean16, rstd16),
                               d16))
        tally.check(same, f"{name} {shape}: runs differ, or autograd and the direct call")
        del ref, got, want
        k_ms = median_ms(lambda: torch.autograd.grad(out16, leaf, g16, retain_graph=True))
        p_ms = median_ms(lambda: ops.relu_instancenorm_backward_plain(x16, g16))
        k_dev = profiled_device_ms(lambda: ops.relu_instancenorm_bwd(x16, g16, mean16, rstd16))
        lib_leaf = ncdhw.detach().requires_grad_()
        lib_out = F.instance_norm(F.relu(lib_leaf))
        g_ncdhw = g16.permute(0, 4, 1, 2, 3).contiguous()
        lib_bwd = lambda: torch.autograd.grad(lib_out, lib_leaf, g_ncdhw,  # noqa: E731
                                              retain_graph=True)
        l_ms = median_ms(lib_bwd)
        l_dev = profiled_device_ms(lib_bwd)
        del out16, lib_out
        bound = bytes_bound_ms(3 * x.numel())
        regime = t_in.plan(shape[0], x[0, ..., 0].numel(), shape[-1], 2, backward=True,
                           max_blocks=t_in._max_blocks(x.device)).regime
        log(f"  {name} {shape} x{calls} ({regime}): f32 max_abs {err.max().item():.3e} (bound "
            f"{K3_ATOL} + {K3_RTOL} rel); bf16 max_abs {e16.max().item():.3e} (bound 2 bf16 "
            f"ulps + the f32 bound); through autograd equal to the direct call, repeatable, "
            f"also on two streams: {same}; bf16 call kernel (autograd) {k_ms:.4f} plain "
            f"{p_ms:.4f} library (autograd) {l_ms:.4f} ms; device (profiler, 20 calls) "
            f"kernel {k_dev:.4f} library {l_dev:.4f} bound {bound:.4f} ms, "
            f"{bound / k_dev:.1%} of the bound")
        tally.add(name, calls, e16.max().item(), k_ms, p_ms, bound, "bytes", l_ms)
        tally.add_device(name, calls, k_dev, l_dev, bound)
    torch.cuda.empty_cache()


def unpack(qkv):
    """The (B, H, N, 64) views q, k, v of a (B, N, 3, H, 64) tensor."""
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def packed_inputs(shape, gen):
    """What the model hands the attention kernels at ``shape`` (B, H, N, 64):
    the qkv projection's (B, N, 3, H, 64) output, and an output gradient that
    is the (B, H, N, 64) view of (B, N, H, 64) memory."""
    b, h, n, d = shape
    return randn((b, n, 3, h, d), gen), randn((b, n, h, d), gen).permute(0, 2, 1, 3)


def plain_attention_graph(ops, qkv, rate, keep):
    """(output, leaves) of the plain version run in f32 under autograd on the
    views of ``qkv``."""
    leaves = [t.detach().float().requires_grad_() for t in unpack(qkv)]
    return ops.attention_plain(*leaves, SCALE, rate, keep), leaves


def attention_step(ops, qkv, g, rate):
    """What a training step runs: ``fused_attention_qkv`` on a projection
    that needs a gradient (K2f writing the lse) and its backward (K2b on the
    tensors the function saved, writing the one gradient buffer). Returns the
    output, the leaf with its gradient, and the graph's output for timing
    further backwards."""
    packed = qkv.detach().clone().requires_grad_()
    out = ops.fused_attention_qkv(packed, SCALE, rate, PHILOX)
    out.backward(g, retain_graph=True)
    return out.detach(), packed, out


def attention_tflops(shape, products, ms):
    b, h, n, d = shape
    return products * 2 * b * h * n * n * d / ms / 1e9


def host_ms(fn, launches=20):
    """What one call of ``fn`` costs the host: ``launches`` calls queued
    without waiting for the card, by the host's clock."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(launches):
        fn()
    took = time.perf_counter() - start
    torch.cuda.synchronize()
    return took / launches * 1e3


def check_attention_forward(ops, tally, b, gen, model="MMVit4"):
    """K2f as the evaluation path launches it: ``fused_attention_qkv`` on the
    (B, N, 3, H, 64) projection under ``no_grad``, so on strided views, with
    the output in (B, N, H, 64) memory and without the lse. The plain
    versions and SDPA are given the same views. Rate 0 is what the
    evaluation runs; rate 0.1 is held to the same bounds here because this is
    the largest batch the kernels see."""
    name = "fused_attention"
    for shape, calls in k2_shapes(b, model):
        bb, h, n, _ = shape
        qkv, _ = packed_inputs(shape, gen)
        qkv16 = qkv.bfloat16()
        q, k, v = unpack(qkv)
        q16, k16, v16 = unpack(qkv16)
        keep = ops.philox_keep_mask(*PHILOX, bb * h, n, RATE, "cuda").view(bb, h, n, n)
        with torch.no_grad():
            err = (ops.fused_attention_qkv(qkv, SCALE)
                   - ops.attention_plain(q, k, v, SCALE)).abs().max().item()
            out16 = ops.fused_attention_qkv(qkv16, SCALE)
            ref16 = ops.attention_plain(q16.float(), k16.float(), v16.float(), SCALE)
            e16 = (out16.float() - ref16).abs().max().item()
            u16 = ulps_of_max(out16, ops.attention_plain(q16, k16, v16, SCALE,
                                                         kernel_rounding=True))
            same = torch.equal(out16, ops.fused_attention(
                q16.contiguous(), k16.contiguous(), v16.contiguous(), SCALE))
            drop16 = ops.fused_attention_qkv(qkv16, SCALE, RATE, PHILOX)
            ref16 = ops.attention_plain(q16.float(), k16.float(), v16.float(), SCALE,
                                        RATE, keep)
            e16d = (drop16.float() - ref16).abs().max().item()
            u16d = ulps_of_max(drop16, ops.attention_plain(q16, k16, v16, SCALE, RATE, keep,
                                                           kernel_rounding=True))
            del ref16, keep
            k_ms = median_ms(lambda: ops.fused_attention_qkv(qkv16, SCALE))
            k_dev = device_ms(lambda: ops.fused_attention_qkv(qkv16, SCALE))
            d_dev = device_ms(lambda: ops.fused_attention_qkv(qkv16, SCALE, RATE, PHILOX))
            p_ms = median_ms(lambda: ops.attention_plain(q16, k16, v16, SCALE))
            l_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q16, k16, v16, scale=SCALE))
            l_dev = device_ms(lambda: F.scaled_dot_product_attention(
                q16, k16, v16, scale=SCALE))
            k_prof = profiled_device_ms(lambda: ops.fused_attention_qkv(qkv16, SCALE))
            l_prof = profiled_device_ms(lambda: F.scaled_dot_product_attention(
                q16, k16, v16, scale=SCALE))
        tally.check(err <= K2_ATOL, f"{name} {shape} no lse f32 {err:.3e}")
        tally.check(e16 <= K2_BF16_ATOL, f"{name} {shape} no lse bf16 {e16:.3e}")
        tally.check(u16 <= K2_ROUNDING_ULPS, f"{name} {shape} no lse bf16 {u16:.2f} ulps")
        tally.check(e16d <= K2_BF16_ATOL, f"{name} {shape} no lse rate {RATE} bf16 {e16d:.3e}")
        tally.check(u16d <= K2_ROUNDING_ULPS,
                    f"{name} {shape} no lse rate {RATE} bf16 {u16d:.2f} ulps")
        tally.check(same, f"{name} {shape} no lse bf16: packed and contiguous calls differ")
        bound, by = attention_bound_ms(shape, 2, 4, lse=False)
        log(f"  {name} {shape} as (B, N, 3, H, 64) views, rate 0, no lse (under no_grad): f32 "
            f"max_abs {err:.3e} (bound {K2_ATOL}); bf16 max_abs {e16:.3e} against f32 (bound "
            f"{K2_BF16_ATOL}), {u16:.2f} ulps of the largest entry against the rounding plain "
            f"version (bound {K2_ROUNDING_ULPS}); at rate {RATE} {e16d:.3e} and {u16d:.2f} "
            f"ulps; equal to the call on contiguous copies {same}; bf16 kernel {k_ms:.4f} (20 "
            f"queued launches: {k_dev:.4f} each, {attention_tflops(shape, 2, k_dev):.1f} "
            f"TFLOP/s; at rate {RATE} {d_dev:.4f}) plain {p_ms:.4f} library (SDPA) {l_ms:.4f} "
            f"(queued: {l_dev:.4f}) bound {bound:.4f} ms ({by}); kernel / SDPA "
            f"{k_ms / l_ms:.2f} (queued {k_dev / l_dev:.2f}), kernel / bound "
            f"{k_ms / bound:.1f} (queued {k_dev / bound:.1f}); device (profiler, 20 calls) "
            f"kernel {k_prof:.4f} SDPA {l_prof:.4f} ms, kernel / SDPA {k_prof / l_prof:.2f}")
        tally.add(name, calls, max(e16, e16d), k_ms, p_ms, bound, by, l_ms)
        tally.add_device(name, calls, k_prof, l_prof, bound)


def check_attention_step(ops, tally, b, gen, rate, model="MMVit4"):
    """K2f with the lse and K2b as a training step launches them: through
    ``fused_attention_qkv`` on a (B, N, 3, H, 64) projection that needs a
    gradient and ``backward`` with a cotangent in (B, N, H, 64) memory, so
    every operand is a strided view and the gradient is one buffer. The plain
    versions and SDPA are given the same views. With ``rate`` > 0 the plain
    version is given ``philox_keep_mask`` of the kernels' Philox key. The
    direct call of ``fused_attention_bwd`` on a separately launched
    forward's output and lse must give the same bits."""
    from corrifnet_tpu_torch.ops import attention as attn

    for shape, calls in k2_shapes(b, model):
        bb, h, n, _ = shape
        qkv, g = packed_inputs(shape, gen)
        qkv16, g16 = qkv.bfloat16(), g.bfloat16()
        q, k, v = unpack(qkv)
        q16, k16, v16 = unpack(qkv16)
        keep = None
        if rate > 0:
            keep = ops.philox_keep_mask(*PHILOX, bb * h, n, rate, "cuda").view(bb, h, n, n)
        tag = f"{shape} rate {rate}"
        fwd, bwd = "fused_attention", "fused_attention_bwd"

        # f32: output and gradients through the wrapper against the plain version
        out, packed, _ = attention_step(ops, qkv, g, rate)
        po, plain_leaves = plain_attention_graph(ops, qkv, rate, keep)
        err = (out - po.detach()).abs().max().item()
        tally.check(err <= K2_ATOL, f"{fwd} {tag} f32 {err:.3e}")
        want = torch.autograd.grad(po, plain_leaves, g)
        gerr = 0.0
        for got, w in zip(unpack(packed.grad), want):
            gerr = max(gerr, (got - w).abs().max().item())
            tally.check(((got - w).abs() <= K2_GRAD_RTOL * w.abs().max() + 1e-6).all(),
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
            torch.equal(got, d) for got, d in zip(unpack(packed.grad), direct))
        tally.check(same, f"{bwd} {tag} f32: autograd and the direct call differ")

        # bf16 against the plain version in f32 on the same bf16 inputs, and
        # against the plain versions that round where the kernels round
        out16, packed16, graph16 = attention_step(ops, qkv16, g16, rate)
        grads16 = unpack(packed16.grad)
        po, plain_leaves = plain_attention_graph(ops, qkv16, rate, keep)
        e16 = (out16.float() - po.detach()).abs().max().item()
        tally.check(e16 <= K2_BF16_ATOL, f"{fwd} {tag} bf16 {e16:.3e}")
        ref = torch.autograd.grad(po, plain_leaves, g16.float())
        ge16 = 0.0
        for got, w in zip(grads16, ref):
            ge16 = max(ge16, (got.float() - w).abs().max().item())
            tally.check(((got.float() - w).abs() <= K2_BF16_GRAD_RTOL * w.abs().max()).all(),
                        f"{bwd} {tag} bf16 {ge16:.3e}")
        del po, plain_leaves, ref
        u16 = ulps_of_max(out16, ops.attention_plain(q16, k16, v16, SCALE, rate, keep,
                                                     kernel_rounding=True))
        out16b, lse16 = attn._launch_fwd(q16, k16, v16, SCALE, rate, *PHILOX, True)
        scores = torch.einsum("bhnd,bhmd->bhnm", q16.float(), k16.float()) * SCALE
        lse16_err = (lse16 - torch.logsumexp(scores, dim=-1)).abs().max().item()
        del scores
        rounded = ops.attention_backward_plain(q16, k16, v16, out16b, lse16, g16, SCALE,
                                               rate, keep, kernel_rounding=True)
        gu16 = max(ulps_of_max(got, w) for got, w in zip(grads16, rounded))
        del rounded
        direct = ops.fused_attention_bwd(q16, k16, v16, out16b, lse16, g16, SCALE, rate,
                                         PHILOX)
        same16 = torch.equal(out16, out16b) and all(
            torch.equal(got, d) for got, d in zip(grads16, direct))
        tally.check(u16 <= K2_ROUNDING_ULPS, f"{fwd} {tag} bf16 {u16:.2f} ulps")
        tally.check(gu16 <= K2_ROUNDING_ULPS, f"{bwd} {tag} bf16 {gu16:.2f} ulps")
        tally.check(lse16_err <= 1e-5, f"{fwd} {tag} bf16 lse {lse16_err:.3e}")
        tally.check(same16, f"{bwd} {tag} bf16: autograd and the direct call differ")

        # times, bf16: forward and backward through the wrapper, as the step
        # runs them; the plain version and SDPA on the same strided views
        k_ms = median_ms(lambda: ops.fused_attention_qkv(packed16, SCALE, rate, PHILOX))
        k_dev = device_ms(lambda: ops.fused_attention_qkv(packed16, SCALE, rate, PHILOX))
        p_ms = median_ms(lambda: ops.attention_plain(q16, k16, v16, SCALE, rate, keep))
        ll = [t.detach().requires_grad_() for t in (q16, k16, v16)]
        # the library: SDPA at the kernels' rate with its own dropout (timing
        # only: its mask is not the kernels'), and at rate 0
        rates = (rate, 0.0) if rate > 0 else (0.0,)
        lib = {}
        for p in rates:
            def sdpa(p=p):
                return F.scaled_dot_product_attention(*ll, scale=SCALE, dropout_p=p)
            lib[p] = (median_ms(sdpa), device_ms(sdpa), profiled_device_ms(sdpa))
        l_ms, l_dev, l_prof = lib[rate]
        k_prof = profiled_device_ms(lambda: ops.fused_attention_qkv(packed16, SCALE, rate,
                                                                    PHILOX))
        bound, by = attention_bound_ms(shape, 2, 4)
        log(f"  {fwd} {tag} as (B, N, 3, H, 64) views, lse (through autograd): f32 max_abs "
            f"{err:.3e} (bound {K2_ATOL}), lse {lse_err:.3e} (bound 1e-5); bf16 max_abs "
            f"{e16:.3e} against f32 (bound {K2_BF16_ATOL}), {u16:.2f} ulps of the largest "
            f"entry against the rounding plain version (bound {K2_ROUNDING_ULPS}), lse "
            f"{lse16_err:.3e}; bf16 kernel {k_ms:.4f} (20 queued launches: {k_dev:.4f} each, "
            f"{attention_tflops(shape, 2, k_dev):.1f} TFLOP/s) plain {p_ms:.4f} library "
            f"(SDPA, dropout {rate}) {l_ms:.4f} (queued: {l_dev:.4f}) bound {bound:.4f} ms "
            f"({by}); kernel / SDPA {k_ms / l_ms:.2f} (queued {k_dev / l_dev:.2f}), kernel / "
            f"bound {k_ms / bound:.1f} (queued {k_dev / bound:.1f}); device (profiler, 20 "
            f"calls) kernel {k_prof:.4f} SDPA {l_prof:.4f} ms, kernel / SDPA "
            f"{k_prof / l_prof:.2f}" + sdpa_rate0(lib, rate, k_prof))
        tally.add(fwd, calls, e16, k_ms, p_ms, bound, by, l_ms)
        tally.add_device(fwd, calls, k_prof, l_prof, bound)

        def direct_bwd():
            return attn._launch_bwd(q16, k16, v16, out16b, lse16, g16, SCALE, rate, *PHILOX)

        k_ms = median_ms(lambda: torch.autograd.grad(graph16, packed16, g16, retain_graph=True))
        k_dev, k_host = device_ms(direct_bwd), host_ms(direct_bwd)
        lp = [t.detach().requires_grad_() for t in (q16, k16, v16)]
        po = ops.attention_plain(*lp, SCALE, rate, keep)
        p_ms = median_ms(lambda: torch.autograd.grad(po, lp, g16, retain_graph=True))
        lib = {}
        for p in rates:
            lo = F.scaled_dot_product_attention(*ll, scale=SCALE, dropout_p=p)

            def sdpa_bwd(lo=lo):
                return torch.autograd.grad(lo, ll, g16, retain_graph=True)
            lib[p] = (median_ms(sdpa_bwd), device_ms(sdpa_bwd), profiled_device_ms(sdpa_bwd))
            del lo, sdpa_bwd
        l_ms, l_dev, l_prof = lib[rate]
        k_prof = profiled_device_ms(lambda: torch.autograd.grad(graph16, packed16, g16,
                                                                retain_graph=True))
        del po, graph16
        bound, by = attention_bound_ms(shape, 5, 8)
        log(f"  {bwd} {tag} as (B, N, 3, H, 64) views (through autograd, equal to the direct "
            f"call: f32 {same}, bf16 {same16}): f32 max_abs {gerr:.3e} (bound {K2_GRAD_RTOL} "
            f"of max|grad| + 1e-6); bf16 max_abs {ge16:.3e} against f32 (bound "
            f"{K2_BF16_GRAD_RTOL} of max|grad|), {gu16:.2f} ulps of the largest entry against "
            f"the rounding plain version (bound {K2_ROUNDING_ULPS}); bf16 kernel {k_ms:.4f} "
            f"(20 queued launches of the wrapper's launch function: {k_dev:.4f} each, "
            f"{attention_tflops(shape, 5, k_dev):.1f} TFLOP/s of 5 products; its host part "
            f"{k_host:.4f}) plain (autograd) {p_ms:.4f} library (SDPA backward, dropout "
            f"{rate}) {l_ms:.4f} (queued, through autograd: {l_dev:.4f}) bound {bound:.4f} ms "
            f"({by}); kernel / SDPA {k_ms / l_ms:.2f} (queued {k_dev / l_dev:.2f}), kernel / "
            f"bound {k_ms / bound:.1f} (queued {k_dev / bound:.1f}); device (profiler, 20 "
            f"calls, both through autograd) kernel {k_prof:.4f} SDPA {l_prof:.4f} ms, kernel "
            f"/ SDPA {k_prof / l_prof:.2f}" + sdpa_rate0(lib, rate, k_prof))
        tally.add(bwd, calls, ge16, k_ms, p_ms, bound, by, l_ms)
        tally.add_device(bwd, calls, k_prof, l_prof, bound)


def sdpa_rate0(lib, rate, k_prof):
    """The log's note of SDPA at rate 0 beside its time at ``rate`` > 0."""
    if rate == 0:
        return ""
    l_ms, l_dev, l_prof = lib[0.0]
    return (f"; SDPA at rate 0: {l_ms:.4f} (queued {l_dev:.4f}), device {l_prof:.4f} ms, "
            f"kernel / SDPA at rate 0 {k_prof / l_prof:.2f}")


def check_attention_strided(ops, tally, b, gen, model="MMVit4"):
    """At each attention shape, the kernels on the (B, H, N, 64) views of a
    (B, N, 3, H, 64) qkv tensor and a (B, N, H, 64) cotangent against the
    same calls on contiguous copies, and ``fused_attention_qkv`` against
    ``fused_attention``, under autograd with dropout: equal bits; two
    backward runs: equal bits."""
    from corrifnet_tpu_torch.ops import attention as attn

    for (_, h, n, _), _ in k2_shapes(b, model):
        for dtype in (torch.float32, torch.bfloat16):
            qkv, g = (t.to(dtype) for t in packed_inputs((b, h, n, 64), gen))
            views = unpack(qkv)
            copies = [t.contiguous() for t in views]
            o1, l1 = attn._launch_fwd(*views, SCALE, RATE, *PHILOX, True)
            o2, l2 = attn._launch_fwd(*copies, SCALE, RATE, *PHILOX, True)
            g1 = ops.fused_attention_bwd(*views, o1, l1, g, SCALE, RATE, PHILOX)
            g2 = ops.fused_attention_bwd(*copies, o2.contiguous(), l2, g.contiguous(), SCALE,
                                         RATE, PHILOX)
            g3 = ops.fused_attention_bwd(*views, o1, l1, g, SCALE, RATE, PHILOX)
            strided = (torch.equal(o1, o2) and torch.equal(l1, l2)
                       and all(torch.equal(a, c) for a, c in zip(g1, g2)))
            repeat = all(torch.equal(a, c) for a, c in zip(g1, g3))
            packed = qkv.clone().requires_grad_()
            out_p = ops.fused_attention_qkv(packed, SCALE, RATE, PHILOX)
            out_p.backward(g)
            leaves = [t.clone().requires_grad_() for t in views]
            out_u = ops.fused_attention(*leaves, SCALE, RATE, PHILOX)
            out_u.backward(g)
            unpacked = torch.stack([t.grad for t in leaves]).permute(1, 3, 0, 2, 4)
            same = torch.equal(out_p, out_u) and torch.equal(packed.grad, unpacked)
            no_copy = (out_p.transpose(1, 2).reshape(b, n, h * 64).data_ptr()
                       == out_p.data_ptr() and packed.grad.is_contiguous())
            log(f"  attention on strided (B, N, 3, H, 64) views, B={b} N={n} {dtype}: equal "
                f"to the contiguous call {strided}; backward repeatable {repeat}; "
                f"fused_attention_qkv equal to fused_attention {same}; output and gradient "
                f"need no layout copy {no_copy}")
            tally.check(strided, f"attention strided != contiguous N={n} {dtype}")
            tally.check(repeat, f"attention backward not repeatable N={n} {dtype}")
            tally.check(same, f"fused_attention_qkv != fused_attention N={n} {dtype}")
            tally.check(no_copy, f"attention output or gradient layout N={n} {dtype}")


def check_keep_mask(ops, tally, n=2048):
    from corrifnet_tpu_torch.ops.attention import kernel_keep_mask

    count, bh0 = 3, 13
    want = ops.philox_keep_mask(*PHILOX, count, n, RATE, "cuda", bh0=bh0)
    for layout in ("tile", "rows", "cols"):
        got = kernel_keep_mask(*PHILOX, bh0, count, n, RATE, layout=layout)
        same = torch.equal(got, want)
        log(f"  keep mask ({count}, {n}, {n}) from the kernels' device function "
            f"'{layout}' equals philox_keep_mask: {same}")
        tally.check(same, f"keep mask '{layout}' differs from philox_keep_mask")
    rate = want.float().mean().item()
    sigma = (RATE * (1 - RATE) / want.numel()) ** 0.5
    log(f"  keep rate {rate:.6f} (0.9 +- 4 sigma = {4 * sigma:.6f}); rows differ "
        f"between heads: {not torch.equal(want[0], want[1])}")
    tally.check(abs(rate - (1 - RATE)) <= 4 * sigma, f"keep rate {rate}")
    tally.check(not torch.equal(want[0], want[1]), "keep mask repeats across heads")


def rel_max(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def fused_conv_bound_ms(rows, ci, co, taps, backward):
    """max(bytes, operations) of one fused conv in bf16: forward reads x and
    w and writes y; backward reads x, w, y, dy and writes dx and dw; the
    per-channel vectors are left out. 2 rows ci co taps operations forward,
    twice that backward."""
    weight = taps * ci * co
    moved = 2 * ((2 * rows * (ci + co) + 2 * weight) if backward
                 else (rows * (ci + co) + weight))
    flops = (4 if backward else 2) * rows * ci * co * taps
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def library_fused_conv(x, w_lib, a, b, taps, stats=True):
    """The same function from library calls and tensor ops: BatchNorm apply
    and ReLU, ``F.linear`` or ``F.conv2d`` (``w_lib`` in the library's
    layout), statistics from the f32 cast of the output. Timed only."""
    z = torch.relu(x * a.to(x.dtype) + b.to(x.dtype)) if a is not None else x
    y = F.linear(z, w_lib) if taps == 1 else F.conv2d(z.permute(0, 3, 1, 2), w_lib,
                                                      padding=1)
    if not stats:
        return y
    yf, dims = y.float(), (0,) if taps == 1 else (0, 2, 3)
    y = y if taps == 1 else y.permute(0, 2, 3, 1)
    return y, yf.sum(dim=dims), (yf * yf).sum(dim=dims)


def fused_conv_inputs(gen, xs, co, prologue, dtype):
    """(x, w, a, b) of one fused conv: unit-variance x, w scaled so that y
    is O(1), a in [0.5, 1.5), b ~ 0.3 N(0, 1); (a, b) None without a prologue."""
    taps, ci = (1 if len(xs) == 2 else 9), xs[-1]
    x = randn(xs, gen).to(dtype)
    w = (randn((ci, co) if taps == 1 else (3, 3, ci, co), gen) / (taps * ci) ** 0.5).to(dtype)
    a = torch.rand(ci, generator=gen, device="cuda") + 0.5 if prologue else None
    b = 0.3 * randn((ci,), gen) if prologue else None
    return x, w, a, b


def library_weight(w):
    """The (ci, co) or (3, 3, ci, co) weight in ``F.linear``'s or ``F.conv2d``'s layout."""
    if w.dim() == 2:
        return w.t().contiguous()
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def device_line(rows, ci, co, taps, k_dev, l_dev, bound, backward=False):
    """Device times of a K4 forward (or backward) and its library composition."""
    tflops = (4 if backward else 2) * rows * ci * co * taps / k_dev / 1e9
    return (f"device (profiler, 20 calls) kernel {k_dev:.4f} library {l_dev:.4f} ms, "
            f"kernel / library {k_dev / l_dev:.2f}, {tflops:.1f} TFLOP/s, "
            f"{bound / k_dev:.1%} of the bound")


def check_fused_conv_forward(ops, tally, gen, xs, co, prologue, calls):
    """K4a or K4c as the evaluation path launches it: under ``no_grad``,
    without the statistics, in bf16."""
    taps = 1 if len(xs) == 2 else 9
    name = "pointwise_conv_stats" if taps == 1 else "conv3x3_fma_relu_stats"
    fwd, plain = getattr(ops, name), getattr(ops, name + "_plain")
    args = fused_conv_inputs(gen, xs, co, prologue, torch.bfloat16)
    w_lib = library_weight(args[1])
    with torch.no_grad():
        y, s, q = fwd(*args, stats=False)
        want = plain(*args)[0]
        err = rel_max(y, want)
        tally.check(err <= K4_BF16 and s is None and q is None,
                    f"{name} {xs} -> {co} no statistics bf16 {err:.1e}")
        k_ms = median_ms(lambda: fwd(*args, stats=False))
        p_ms = median_ms(lambda: plain(*args))
        lib = lambda: library_fused_conv(args[0], w_lib, args[2], args[3],  # noqa: E731
                                         taps, stats=False)
        l_ms = median_ms(lib)
        k_dev = profiled_device_ms(lambda: fwd(*args, stats=False))
        l_dev = profiled_device_ms(lib)
    rows = int(np.prod(xs[:-1]))
    bound, by = fused_conv_bound_ms(rows, xs[-1], co, taps, False)
    log(f"  {name} {xs} -> {co}{' prologue' if prologue else ''} x{calls * ENCODERS}, no "
        f"statistics (under no_grad): bf16 rel-max {err:.1e} (bound {K4_BF16}); kernel "
        f"{k_ms:.4f} plain {p_ms:.4f} library {l_ms:.4f} bound {bound:.4f} ms ({by}); "
        f"{device_line(rows, xs[-1], co, taps, k_dev, l_dev, bound)}")
    tally.add(name, calls * ENCODERS, (y.float() - want.float()).abs().max().item(),
              k_ms, p_ms, bound, by, l_ms)
    tally.add_device(name, calls * ENCODERS, k_dev, l_dev, bound)


def fused_conv_step(fn, args, cotangents):
    """What a training step runs: the wrapper on leaves that need gradients
    and the backward with all three cotangents. Returns the outputs, the
    gradients and (graph outputs, leaves) for timing further backwards."""
    leaves = [t.detach().clone().requires_grad_() for t in args if t is not None]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, cotangents, retain_graph=True)
    return [o.detach() for o in out], grads, (out, leaves)


def check_fused_conv(ops, tally, gen, xs, co, prologue, calls):
    """K4a+K4b (``xs`` = (rows, ci)) or K4c+K4d (``xs`` = (B, H, W, ci))
    against their plain versions in f32 and bf16, and their bf16 times."""
    taps = 1 if len(xs) == 2 else 9
    name = "pointwise_conv_stats" if taps == 1 else "conv3x3_fma_relu_stats"
    fwd, plain = getattr(ops, name), getattr(ops, name + "_plain")
    plain_bwd = getattr(ops, name + "_backward_plain")
    ci, rows = xs[-1], int(np.prod(xs[:-1]))
    x, w, a, b = fused_conv_inputs(gen, xs, co, prologue, torch.float32)
    cot = (randn((*xs[:-1], co), gen), 0.3 * randn((co,), gen), 0.01 * randn((co,), gen))
    tag = f"{name} {xs} -> {co}{' prologue' if prologue else ''}"

    errs = {}
    for dtype, bound, stats_bound in ((torch.float32, K4_F32, K4_F32),
                                      (torch.bfloat16, K4_BF16, K4_BF16_STATS)):
        args = (x.to(dtype), w.to(dtype), a, b)
        cots = (cot[0].to(dtype), cot[1], cot[2])
        out, grads, graph = fused_conv_step(fwd, args, cots)
        want = plain(*args)
        want_grads = [g for g in plain_bwd(*args, out[0], *cots) if g is not None]
        e_out = [rel_max(g, r) for g, r in zip(out, want)]
        e_grad = [rel_max(g, r) for g, r in zip(grads, want_grads)]
        short = "f32" if dtype == torch.float32 else "bf16"
        tally.check(e_out[0] <= bound and max(e_out[1:]) <= stats_bound,
                    f"{tag} {short} forward {e_out}")
        tally.check(len(grads) == len(want_grads) and max(e_grad) <= bound,
                    f"{tag} {short} backward {e_grad}")
        errs[short] = (e_out, e_grad)
    # bf16 from here on: repeatability, the evaluation variant, the times
    out2, grads2, _ = fused_conv_step(fwd, args, cots)
    same = all(torch.equal(u, v) for u, v in zip((*out, *grads), (*out2, *grads2)))
    with torch.no_grad():
        y_eval, s_eval, q_eval = fwd(*args, stats=False)
    same_eval = torch.equal(y_eval, out[0]) and s_eval is None and q_eval is None
    tally.check(same, f"{tag}: two runs differ")
    tally.check(same_eval, f"{tag}: y without the statistics differs")
    abs_fwd = (out[0].float() - want[0].float()).abs().max().item()
    abs_bwd = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(grads, want_grads))

    with torch.no_grad():  # the forward with the statistics alone, on the card
        w_lib = library_weight(args[1])
        k_dev = profiled_device_ms(lambda: fwd(*args))
        l_dev = profiled_device_ms(lambda: library_fused_conv(args[0], w_lib, a, b, taps))
        # the backward alone: the kernel's passes from the saved tensors
        bwd = getattr(ops, name + "_bwd")
        k_bdev = profiled_device_ms(lambda: bwd(*args, out[0], *cots))
    leaves = graph[1]
    k_f = median_ms(lambda: fwd(*leaves))
    k_b = median_ms(lambda: torch.autograd.grad(*graph, cots, retain_graph=True))
    p_f = median_ms(lambda: plain(*args))
    p_b = median_ms(lambda: plain_bwd(*args, out[0], *cots))
    lib_leaves = [t.detach().clone().requires_grad_()
                  for t in (args[0], library_weight(args[1]), a, b) if t is not None]
    lib = lambda: library_fused_conv(  # noqa: E731
        lib_leaves[0], lib_leaves[1], *(lib_leaves[2:] or (None, None)), taps)
    l_f = median_ms(lib)
    lib_out = lib()
    l_b = median_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, cots,
                                                retain_graph=True))
    l_bdev = profiled_device_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, cots,
                                                            retain_graph=True))
    (bf, byf), (bb, byb) = (fused_conv_bound_ms(rows, ci, co, taps, back)
                            for back in (False, True))
    log(f"  {tag} x{calls * ENCODERS}: rel-max f32 fwd {max(errs['f32'][0]):.1e} bwd "
        f"{max(errs['f32'][1]):.1e} (bound {K4_F32}); bf16 y {errs['bf16'][0][0]:.1e} "
        f"grads {max(errs['bf16'][1]):.1e} (bound {K4_BF16}) s,q "
        f"{max(errs['bf16'][0][1:]):.1e} (bound {K4_BF16_STATS}); repeatable {same}, "
        f"eval y equal {same_eval}; bf16 ms fwd kernel {k_f:.4f} plain {p_f:.4f} library "
        f"{l_f:.4f} bound {bf:.4f} ({byf}); bwd kernel {k_b:.4f} plain {p_b:.4f} library "
        f"{l_b:.4f} bound {bb:.4f} ({byb}); forward with statistics "
        f"{device_line(rows, ci, co, taps, k_dev, l_dev, bf)}; backward "
        f"{device_line(rows, ci, co, taps, k_bdev, l_bdev, bb, backward=True)}")
    n = calls * ENCODERS
    tally.add(name, n, abs_fwd, k_f, p_f, bf, byf, l_f)
    tally.add_device(name, n, k_dev, l_dev, bf)
    tally.add(name + "_bwd", n, abs_bwd, k_b, p_b, bb, byb, l_b)
    tally.add_device(name + "_bwd", n, k_bdev, l_bdev, bb)


def check_fused_convs(ops, tally, b, gen, backward):
    pointwise, conv = k4_pointwise_shapes(b), k4_conv_shapes(b)
    counts = {"pointwise_conv_stats": ENCODERS * sum(s[-1] for s in pointwise),
              "conv3x3_fma_relu_stats": ENCODERS * sum(s[-1] for s in conv)}
    if counts != K4_PER_FORWARD:
        raise AssertionError(f"shape lists give {counts}, the model {K4_PER_FORWARD}")
    check = check_fused_conv if backward else check_fused_conv_forward
    for rows, ci, co, prologue, calls in pointwise:
        check(ops, tally, gen, (rows, ci), co, prologue, calls)
    for xs, calls in conv:
        check(ops, tally, gen, xs, xs[-1], True, calls)
    torch.cuda.empty_cache()


def phase_kernels(ops):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # K4's inputs come from a generator of their own, so that K1-K3 see the
    # inputs they saw before K4 was added
    gen4 = torch.Generator(device="cuda").manual_seed(4)
    log(f" evaluation shapes (B={EVAL_B}), forward kernels, sums over one forward:")
    fwd = Tally()
    check_correlation(ops, fwd, EVAL_B, gen, backward=False)
    check_attention_forward(ops, fwd, EVAL_B, gen)
    check_instancenorm(ops, fwd, EVAL_B, gen, backward=False)
    check_fused_convs(ops, fwd, EVAL_B, gen4, backward=False)
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
    # inputs from a generator of its own, as K4's: K3 sees what it saw before
    check_attention_strided(ops, step, TRAIN_B,
                            torch.Generator(device="cuda").manual_seed(2))
    check_instancenorm(ops, step, TRAIN_B, gen, backward=True)
    log(f" fused bottleneck convolutions at the encoders' shapes (B={TRAIN_B}), "
        f"calls per step over the three encoders:")
    check_fused_convs(ops, step, TRAIN_B, gen4, backward=True)
    step.report(f"B={TRAIN_B} training step")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    failures = fwd.failures + rate0.failures + step.failures + phase_kernels_conv_family(ops)
    if failures:
        raise AssertionError(f"kernels outside their bounds: {failures}")
    return step.rows


def phase_kernels_conv_family(ops):
    """Phase 3 at the shapes MMVit2 and mmformer add: K2f and K2b with the
    multimodal transformer at N=1536 (3 token groups), K3 and K3b at the
    conv encoders' and the RFM blocks' volumes (the decoder chain's are
    MMVit4's, checked above). Inputs from a generator of their own. Returns
    the failures."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    log(f" MMVit2 and mmformer, evaluation shapes (B={EVAL_B}), sums over one forward "
        f"(K3: the encoders' and the RFM blocks' calls):")
    fwd = Tally()
    check_attention_forward(ops, fwd, EVAL_B, gen, model="MMVit2")
    check_instancenorm(ops, fwd, EVAL_B, gen, backward=False,
                       shapes=k3_conv_family_shapes(EVAL_B, chain=False))
    fwd.report(f"MMVit2 B={EVAL_B} forward")
    torch.cuda.empty_cache()
    log(f" MMVit2 and mmformer, training shapes (B={TRAIN_B}), sums over one step:")
    step, rate0 = Tally(), Tally()
    check_attention_step(ops, rate0, TRAIN_B, gen, 0.0, model="MMVit2")
    rate0.report(f"MMVit2 B={TRAIN_B} rate 0")
    check_attention_step(ops, step, TRAIN_B, gen, RATE, model="MMVit2")
    check_keep_mask(ops, step, n=1536)
    check_attention_strided(ops, step, TRAIN_B, gen, model="MMVit2")
    check_instancenorm(ops, step, TRAIN_B, gen, backward=True,
                       shapes=k3_conv_family_shapes(TRAIN_B, chain=False))
    step.report(f"MMVit2 B={TRAIN_B} training step")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return fwd.failures + rate0.failures + step.failures


# ------------------------------------------------------------------ slices


def write_run_inputs(n, tmp, name, **extra):
    """randInd{n}.txt and a JSON config (the 18-line defaults with MMVit4,
    or ``modeltype`` in ``extra``) in ``tmp``, which must be the working
    directory: cross_val reads the permutation from there."""
    perm = np.random.default_rng(0).permutation(n)
    (Path(tmp) / f"randInd{n}.txt").write_text("\n".join(map(str, perm)) + "\n")
    cfg = Path(tmp) / name
    cfg.write_text(json.dumps({"train_set_size": n, "fno": 2, "fsiz": 5,
                               "modeltype": "MMVit4", "synthetic_seed": 0, **extra}))
    return cfg


def evaluate(n, tmp, fused, model="MMVit4"):
    """Drive the evaluation CLI over fold 2 of 5 of ``n`` synthetic patches."""
    from corrifnet_tpu_torch.run.evaluate import main as evaluate_main

    cfg = write_run_inputs(n, tmp, f"eval{n}_{int(fused)}_{model}.json",
                           pallas_fused_blocks=fused, modeltype=model)
    return evaluate_main(["--config", str(cfg), "--device", "cuda"])


def reset_counts(ops):
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0


def read_counts(ops):
    torch.cuda.synchronize()
    return {n: w.launches for n, w in ops.KERNELS.items()}


def k4_counts(forwards, steps, fused):
    """The K4 launches of ``forwards`` forwards, ``steps`` of them with a
    backward: none with the flag off."""
    per = K4_PER_FORWARD if fused else dict.fromkeys(K4_PER_FORWARD, 0)
    want = {name: forwards * n for name, n in per.items()}
    want.update({name + "_bwd": steps * n for name, n in per.items()})
    return want


def phase_eval_slice(ops, tmp, fused=False, model="MMVit4"):
    """16 images of ``model`` through the entry point with the launch
    counters reset just before and read just after; then a test fold of 48
    images (6 batches) timed through the same entry point. Returns the
    launch counts and the timed numbers."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    r = evaluate(80, tmp, fused, model)
    launches = read_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    timed = evaluate(TIMED_SET, tmp, fused, model)
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
    want = MODEL_LAUNCHES[model]
    if not (per_forward["correlation_fusion"] == want["k1"]
            and per_forward["fused_attention"] == want["k2"]
            and per_forward["relu_instancenorm"] == want["k3_eval"]
            and per_forward["relu_instancenorm_bwd"] == 0
            and per_forward["correlation_fusion_bwd"] == 0
            and per_forward["fused_attention_bwd"] == 0
            and all(launches[k] == v for k, v in k4_counts(forwards, 0, fused).items())):
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
    return launches, {"images_per_s": EVAL_B / med, "batch_seconds": med,
                      "peak_bytes": peak}


def phase_train_slice(ops, tmp, fused=False, model="MMVit4", repeat=False):
    """The training CLI at full width for one epoch of 8 steps of ``model``,
    validation by checkpoint and the test; launch counters reset just before
    and read just after. With ``repeat``, ``--indices 0,1`` over a ``{i}``
    config template: two identical runs, whose final checkpoints and log
    values must be equal bit for bit. Returns the launch counts of the
    run(s) and the (first) run's timed numbers."""
    from corrifnet_tpu_torch.run.main import main as train_main

    name = f"train_{int(fused)}_{model}"
    for i in (0, 1) if repeat else (0,):
        cfg = write_run_inputs(TRAIN_SET, tmp, f"{name}_{i}.json", n_epochs=1,
                               pallas_fused_blocks=fused, modeltype=model)
    args = (["--config", str(Path(tmp) / f"{name}_{{i}}.json"), "--indices", "0,1"]
            if repeat else ["--config", str(cfg)])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    runs = train_main([*args, "--run-root", str(Path(tmp) / name), "--device", "cuda"])
    launches = read_counts(ops)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    runs = runs if repeat else {0: runs}

    r = runs[0]
    steps = r["train_steps"]
    log(f"  {len(runs)} run(s) of {steps} training steps and {TRAIN_EVALS} evaluation "
        f"batches in {wall:.2f} s; launches {launches}")
    check_train_launches(launches, steps, fused, model, runs=len(runs))
    for i, run in runs.items():
        check_resident(run, RESIDENT_BYTES)
        check_run(run, i, epochs=1)
    if repeat:
        diff = run_difference(run_values(runs[0], 0), run_values(runs[1], 1))
        log(f"  model0 against model1: largest difference over every tensor of "
            f"Finaliremmodel and every log value %.6e (%s)" % largest(diff))
        if largest(diff)[0] != 0:
            raise AssertionError(f"two identical {model} runs differ: {largest(diff)}")
    med = median_step_seconds(r, peak)
    return launches, {"patches_per_s": TRAIN_B / med, "step_seconds": med,
                      "peak_bytes": peak}


def check_train_launches(launches, steps, fused=False, model="MMVit4", runs=1):
    """The launches of ``runs`` runs of one epoch of ``steps`` training steps
    of ``model`` and its TRAIN_EVALS evaluation batches."""
    evals = TRAIN_EVALS
    per = MODEL_LAUNCHES[model]
    k1, k2, k3 = (runs * per[k] for k in ("k1", "k2", "k3_step"))
    want = {"correlation_fusion": k1 * (steps + evals), "correlation_fusion_bwd": k1 * steps,
            "fused_attention": k2 * (steps + evals), "fused_attention_bwd": k2 * steps,
            # lean at B <= 4, the evaluation batches of the run included
            "relu_instancenorm": k3 * (steps + evals),
            "relu_instancenorm_bwd": k3 * steps,
            **k4_counts(runs * (steps + evals), runs * steps, fused)}
    fwd, bwd = runs * (steps + evals), runs * steps
    log(f"  per training step: K1f {launches['correlation_fusion'] / fwd:g}, "
        f"K1b {launches['correlation_fusion_bwd'] / bwd:g}, "
        f"K2f {launches['fused_attention'] / fwd:g}, "
        f"K2b {launches['fused_attention_bwd'] / bwd:g}, "
        f"K3 {launches['relu_instancenorm'] / fwd:g}, K3b "
        f"{launches['relu_instancenorm_bwd'] / bwd:g} (forward-only batches launch "
        f"K1f {per['k1']}, K2f {per['k2']}, K3 {per['k3_step']} each); K4a "
        f"{launches['pointwise_conv_stats'] / fwd:g} and K4c "
        f"{launches['conv3x3_fma_relu_stats'] / fwd:g} per forward, K4b "
        f"{launches['pointwise_conv_stats_bwd'] / bwd:g} and K4d "
        f"{launches['conv3x3_fma_relu_stats_bwd'] / bwd:g} per step")
    if steps != 8 or launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")


def check_resident(r, want):
    """The run kept ``want`` bytes on the card (0: it streamed)."""
    log(f"  resident on the card: {r['resident_bytes']} bytes (expected {want})")
    if r["resident_bytes"] != want:
        raise AssertionError(f"resident bytes {r['resident_bytes']}, expected {want}")


def check_run(r, index, epochs):
    """The run directory holds every file of a run, and the losses and
    Jaccards of its last epoch and its test are in their bands."""
    run_dir = Path(r["run_dir"])
    files = ["lrFile.txt", *LOG_FILES, "fpsfile.txt", f"iremmodel{index}",
             f"Finaliremmodel{index}",
             # the first test image's segplot family; the curves need matplotlib
             # (without it the run prints one line naming them)
             "segmentation_image.png", "test_image.png", "test_image_R.png",
             "test_image_G.png", "test_image_B.png", "test_pred_mask.png",
             "ground_truth_mask.png"]
    if importlib.util.find_spec("matplotlib") is not None:
        files += ["learning_curves.png", "accuracy_curves.png"]
    missing = [f for f in files if not (run_dir / f).exists()
               or (run_dir / f).stat().st_size == 0]
    if missing:
        raise AssertionError(f"run directory lacks {missing}")
    h = r["history"]
    if len(h["train_loss"]) != epochs or len(h["val_jac"]) != epochs:
        raise AssertionError(f"{epochs} epochs expected: {h}")
    losses = {"train": h["train_loss"][-1], "validation": h["val_loss"][-1],
              "test": r["test_loss"]}
    jaccards = {"train": h["train_jac"][-1], "validation": h["val_jac"][-1],
                "test": r["test_jaccard"]}
    log(f"  losses {losses}; jaccards {jaccards}; test FPS {r['fps']:.3f}")
    for what, value in losses.items():
        if not 0.5 <= value <= 1.0:
            raise AssertionError(f"{what} loss {value} outside the double-sigmoid "
                                 f"band 0.5-1.0")
    for what, value in jaccards.items():
        if not (np.isfinite(value) and 0.0 <= value <= 1.0):
            raise AssertionError(f"{what} jaccard {value}")


def median_step_seconds(r, peak):
    rest = r["history"]["step_seconds"][2:]
    med = statistics.median(rest)
    log(f"  step seconds after the first two steps ({len(rest)} steps, the last "
        f"of an epoch a padded batch): median {med:.4f} (min {min(rest):.4f}, max "
        f"{max(rest):.4f}); patches/s {TRAIN_B / med:.3f} (from the max "
        f"{TRAIN_B / max(rest):.3f}, from the min {TRAIN_B / min(rest):.3f}); peak "
        f"memory allocated {peak} bytes ({peak / 2 ** 30:.3f} GiB)")
    return med


_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def run_values(r, index):
    """{name: flat f64 tensor} of a run: every tensor of its final
    checkpoint, and the numbers of each log file (fpsfile aside: a time),
    lrFile's deadline line left out."""
    run_dir = Path(r["run_dir"])
    final = torch.load(run_dir / f"Finaliremmodel{index}", weights_only=True)
    values = {k: v.double().flatten() for k, v in final.items()}
    for name in ("lrFile.txt", *LOG_FILES):
        lines = (run_dir / name).read_text().splitlines()
        values[name] = torch.tensor([float(x) for ln in lines
                                     if not ln.startswith("deadline reached")
                                     for x in _NUMBER.findall(ln)], dtype=torch.float64)
    return values


def run_difference(a, b):
    """{name: largest |difference|} between two runs' ``run_values``."""
    if a.keys() != b.keys() or any(a[k].shape != b[k].shape for k in a):
        raise AssertionError("the runs' checkpoints or log files differ in structure")
    return {k: (a[k] - b[k]).abs().max().item() if a[k].numel() else 0.0 for k in a}


def largest(d, names=None):
    """(value, name) of the largest entry of ``d`` (over ``names``)."""
    top = max(names or d, key=d.get)
    return d[top], top


def phase_run_level(ops, tmp):
    """The training entry point's run-level features at full width, every
    run through ``run.main.main`` over TRAIN_SET patches, two epochs with
    extended checkpoints: (a) ``--indices 0,1`` over a ``{i}`` template, two
    identical runs with the data resident and the wire cast on, whose
    largest difference is the witness, which must be 0 (the port's training
    repeats its bits); (b) the same streamed (``CORRIFNET_DEVICE_DATA=0``),
    within twice the witness of (a)'s model0, so equal to it bit for bit;
    (c) ``--train-deadline-s 0.001`` (one epoch, tested, ``state0@8``),
    then ``--resume`` to the second epoch, equal to model0 bit for bit as
    well, the kernels' launches read around the resumed run; (d) a ``yestr``
    warm start from (a)'s ``Finaliremmodel0``, one epoch."""
    from corrifnet_tpu_torch.run.main import main as train_main

    for i in (0, 1):
        write_run_inputs(TRAIN_SET, tmp, f"run_{i}.json", n_epochs=2,
                         extended_checkpoints=True)
    template, cfg0 = str(Path(tmp) / "run_{i}.json"), str(Path(tmp) / "run_0.json")

    def train(*args):
        return train_main(["--device", "cuda", *args])

    log("  (a) --indices 0,1: two identical runs, the data resident, the wire cast on")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = train("--config", template, "--indices", "0,1", "--run-root", f"{tmp}/a")
    peak = torch.cuda.max_memory_allocated()
    for i in (0, 1):
        check_resident(runs[i], RESIDENT_BYTES)
        check_run(runs[i], i, epochs=2)
    model0 = run_values(runs[0], 0)
    witness = run_difference(model0, run_values(runs[1], 1))
    logs = [k for k in witness if k.endswith(".txt")]
    log(f"  witness, model0 against model1: largest difference over every tensor of "
        f"Finaliremmodel and every log value %.6e (%s); over the log values alone "
        f"%.6e (%s)" % (*largest(witness), *largest(witness, logs)))
    resident_s = median_step_seconds(runs[0], peak)
    if largest(witness)[0] != 0:
        raise AssertionError(f"two identical runs differ (F5): {largest(witness)}")

    def within_witness(what, r):
        d = run_difference(model0, run_values(r, 0))
        ratio = {k: d[k] / witness[k] if witness[k] else (0.0 if d[k] == 0 else
                                                            float("inf")) for k in d}
        log(f"  {what} against model0: largest difference %.6e (%s), bound twice the "
            f"witness, {2 * largest(witness)[0]:.6e}; over the log values %.6e (%s); "
            f"per tensor or file over its own witness: largest %.3f (%s), over 1.5 "
            f"{sum(v > 1.5 for v in ratio.values())}, over 2 "
            f"{sum(v > 2 for v in ratio.values())} of {len(ratio)}"
            % (*largest(d), *largest(d, logs), *largest(ratio)))
        if largest(d)[0] > 2 * largest(witness)[0]:
            raise AssertionError(f"{what} differs from model0 by {largest(d)}, the "
                                 f"witness is {largest(witness)}")

    log("  (b) the same run streamed (CORRIFNET_DEVICE_DATA=0)")
    before = os.environ.get("CORRIFNET_DEVICE_DATA")
    os.environ["CORRIFNET_DEVICE_DATA"] = "0"
    try:
        torch.cuda.reset_peak_memory_stats()
        streamed = train("--config", cfg0, "--run-root", f"{tmp}/b")
        streamed_peak = torch.cuda.max_memory_allocated()
    finally:
        if before is None:
            del os.environ["CORRIFNET_DEVICE_DATA"]
        else:
            os.environ["CORRIFNET_DEVICE_DATA"] = before
    check_resident(streamed, 0)
    check_run(streamed, 0, epochs=2)
    within_witness("streamed", streamed)
    streamed_s = median_step_seconds(streamed, streamed_peak)
    log(f"  resident / streamed: median step {resident_s:.4f} / {streamed_s:.4f} s, "
        f"patches/s {TRAIN_B / resident_s:.3f} / {TRAIN_B / streamed_s:.3f}, peak memory "
        f"{peak} / {streamed_peak} bytes")

    log("  (c) --train-deadline-s 0.001, then --resume")
    first = train("--config", cfg0, "--run-root", f"{tmp}/c", "--train-deadline-s", "0.001")
    run_dir = Path(first["run_dir"])
    check_run(first, 0, epochs=1)
    states = sorted(p.name for p in run_dir.glob("state0*"))
    if states != ["state0@8"]:
        raise AssertionError(f"after the deadline: {states}, expected state0@8")
    reset_counts(ops)
    resumed = train("--config", cfg0, "--resume", str(run_dir))
    launches = read_counts(ops)
    check_train_launches(launches, resumed["train_steps"] - 8)
    check_run(resumed, 0, epochs=2)
    epochs = (run_dir / "trainepochFile.txt").read_text().split()
    lr = (run_dir / "lrFile.txt").read_text()
    headers = [lr.count(f"Epoch: {e} LR:") for e in (0, 1)]
    log(f"  resumed: trainepochFile {epochs}, lrFile headers per epoch {headers}, "
        f"deadline line kept {'deadline reached after epoch 0' in lr}")
    if epochs != ["0", "1"] or headers != [1, 1]:
        raise AssertionError(f"resumed logs: trainepochFile {epochs}, headers {headers}")
    within_witness("deadline then resume", resumed)

    log("  (d) transfertype yestr from (a)'s Finaliremmodel0, one epoch")
    warm = write_run_inputs(TRAIN_SET, tmp, "warm.json", n_epochs=1, transfertype="yestr",
                            transfer_checkpoint=str(Path(runs[0]["run_dir"])
                                                    / "Finaliremmodel0"))
    check_run(train("--config", str(warm), "--run-root", f"{tmp}/d"), 0, epochs=1)


def seeded_image():
    return torch.randn((1, 3, 3, 224, 224), generator=torch.Generator().manual_seed(0))


def phase_whole_model(fused=False, model="MMVit4"):
    """One image through ``model`` in f32 on the card (kernels) and on the
    CPU (plain versions), same weights: max |difference| of the
    probabilities within WHOLE_MODEL_ATOL; for MMVit2 and mmformer within
    the larger of that and twice the witness, what the CPU's own output
    moves under a 1e-6 change of the input (MMVit2's correlation softmaxes
    saturate at random initialization and amplify f32 rounding)."""
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.testing import calibrate_batchnorm

    x = seeded_image()
    cpu = create_model(model, dtype=torch.float32, device="cpu", seed=0)
    # O(1) activations, as trained statistics give (see calibrate_batchnorm;
    # MMVit2 and mmformer have no BatchNorm)
    if model == "MMVit4":
        calibrate_batchnorm(cpu, x)
    if fused:
        # same weights and statistics (the calibration hooks BatchNorm.forward,
        # which the fused blocks do not call)
        calibrated = cpu.state_dict()
        cpu = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=0,
                           pallas_fused_blocks=True)
        cpu.load_state_dict(calibrated, strict=True)
    gpu = copy.deepcopy(cpu).to("cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        out_gpu = gpu(x.to("cuda")).cpu()
        t1 = time.perf_counter()
        out_cpu = cpu(x)
        t2 = time.perf_counter()
        witness = 0.0 if model == "MMVit4" else (
            cpu(x * (1 + 1e-6)) - out_cpu).abs().max().item()
    diff = (out_gpu - out_cpu).abs().max().item()
    bound = max(WHOLE_MODEL_ATOL, 2 * witness)
    log(f"  {model} B=1 f32 GPU {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; max |GPU - CPU| "
        f"{diff:.3e} (bound {bound:.3e}"
        + ("" if model == "MMVit4" else f": {WHOLE_MODEL_ATOL}, or twice the witness, the "
           f"CPU against itself under a 1e-6 change of the input, {witness:.3e}")
        + f"); shape {tuple(out_gpu.shape)}")
    if out_gpu.shape != (1, 3, 1, 224, 224) or not bool(torch.isfinite(out_gpu).all()):
        raise AssertionError("whole-model output malformed")
    if not diff <= bound:
        raise AssertionError(f"whole model GPU vs CPU {diff} > {bound}")


def phase_fused_block():
    """One f32 train step of a full-width fused bottleneck (layer 2's widths)
    on the card against the CPU, same weights and input: output, running
    statistics, gradients of the input and of every parameter. The data are
    the first seed on which the CPU's own results move by no more than 1e-5
    under a 1e-6 change of the input (no ReLU input within rounding of 0:
    see ``testing.well_conditioned_block``)."""
    from corrifnet_tpu_torch.models.resnet3d import Bottleneck3D
    from corrifnet_tpu_torch.testing import block_train_step, well_conditioned_block

    for stride, down in ((1, False), (1, True), (2, True)):
        cin = 256 if down else 512
        cpu, x, want, seed = well_conditioned_block(
            lambda: Bottleneck3D(cin, 128, stride, down, pallas_fused=True),
            (2, cin, 3, 28, 28))
        got = block_train_step(copy.deepcopy(cpu).to("cuda"), x)
        errs = {k: rel_max(got[k], v) for k, v in want.items()}
        worst = max(errs, key=errs.get)
        log(f"  stride {stride}, projection {down}, seed {seed}: {len(errs)} tensors, "
            f"worst max |GPU - CPU| / max |CPU| {errs[worst]:.3e} at {worst} "
            f"(bound {FUSED_BLOCK_RTOL})")
        if not errs[worst] <= FUSED_BLOCK_RTOL:
            raise AssertionError(f"fused bottleneck GPU vs CPU: {errs}")


def compare_line(what, unit, off, on):
    log(f"  {what}: flag on {on:.4f} {unit}, flag off {off:.4f} {unit} "
        f"(on / off {on / off:.3f})")


class HostMasks:
    """Dropout keep masks drawn on the host from a seed and moved to the
    tensor's device: the same masks, call by call, on the card and on the
    CPU (RobustMseg's Dropout2d, whose rate is not a model option)."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def keep(self, x, rate):
        return (torch.rand(x.shape, generator=self.gen) >= rate).to(x.device)


def step_gradients(model, x, masks, valid):
    """(loss, {name: gradient on the CPU}) of one training-mode step, the
    dropout that the model cannot turn off given HostMasks(0)."""
    from corrifnet_tpu_torch.train import masked_loss_and_jaccard

    dev = next(model.parameters()).device
    model.set_dropout_rng(HostMasks(0))
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


def phase_train_step(decoder_lean=None, model="MMVit4"):
    """One f32 training step of ``model`` at B=1 without dropout, BatchNorm
    (MMVit4's) on batch statistics: the loss and every gradient tensor on the
    card (kernels, forward and backward) against the CPU (plain versions),
    same weights and input; the decoder lean by the batch rule
    (``decoder_lean=None``) or its fused standard chain (``False``).

    At random initialization the gradient of this network is badly
    conditioned: some forty normalization layers in sequence amplify f32
    rounding, so that both the card's and the CPU's gradient tensors sit 3
    to 6 percent of their norm away from the gradient computed in f64
    (measured once, with the plain versions in f64 on both devices, which
    agree with each other to 3e-12). The yardstick is therefore measured in
    the run: the witness, the CPU against itself with the input scaled by
    1 + 1e-6. The loss is held to 1e-5; every gradient tensor's
    ||GPU - CPU|| / ||CPU|| to twice the witness's worst tensor, and the
    whole gradient's to twice the witness's; for MMVit2 and mmformer, whose
    gradient is better conditioned, a tensor outside that bound is held
    against the step in float64 on the card instead (its card's distance
    within twice the larger of the CPU's and the witness's worst): a conv
    bias before ReLU+InstanceNorm at 128^3 sums two million cancelling
    terms, and the card's and the CPU's f32 sums of it differ by 10% of its
    norm. A backward that is wrong in one branch fails this: the skip gradients that the library's
    nearest-resize backward got wrong on the card (see nn/resize.py) read
    0.49 against a bound near 0.12. The kernels' own backward checks
    (phase 3) are the tight ones."""
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.testing import calibrate_batchnorm

    x = seeded_image()
    gen = torch.Generator().manual_seed(1)
    masks = (torch.rand((1, 3, 1, 224, 224), generator=gen) > 0.5).float()
    valid = torch.ones(1)
    cpu = create_model(model, dtype=torch.float32, device="cpu", seed=0,
                       transformer_dropout=0.0, decoder_lean=decoder_lean)
    if model == "MMVit4":
        calibrate_batchnorm(cpu, x)
    gpu = copy.deepcopy(cpu).to("cuda")
    witness = copy.deepcopy(cpu)
    loss_gpu, g_gpu = step_gradients(gpu, x, masks, valid)
    loss_cpu, g_cpu = step_gradients(cpu, x, masks, valid)
    _, g_wit = step_gradients(witness, x * (1 + 1e-6), masks, valid)
    if sorted(g_gpu) != sorted(g_cpu):
        raise AssertionError("gradients exist for different parameters on GPU and CPU")
    zero = [n for n in g_cpu if model in ZERO_GRADIENT and n.endswith(ZERO_GRADIENT[model])]
    if zero:
        scale = max(g.abs().max().item() for g in g_cpu.values())
        noise = max(g[n].abs().max().item() for g in (g_gpu, g_cpu) for n in zero) / scale
        log(f"  {len(zero)} gradients that are 0 but for rounding ({ZERO_GRADIENT[model]}): "
            f"largest entry {noise:.3e} of the largest gradient entry (bound {ZERO_NOISE})")
        if not noise <= ZERO_NOISE:
            raise AssertionError("a zero gradient is not 0")
        for g in (g_gpu, g_cpu, g_wit):
            for n in zero:
                del g[n]
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
    if not (abs(loss_gpu - loss_cpu) <= STEP_LOSS_ATOL and whole <= bound_whole):
        raise AssertionError("training step GPU vs CPU outside its bounds")
    if worst[0] <= bound_tensor:
        return
    if model == "MMVit4":
        raise AssertionError("training step GPU vs CPU outside its bounds")
    # the conv-encoder family's gradient is better conditioned than MMVit4's,
    # so its witness no longer covers the conv biases before ReLU+InstanceNorm,
    # whose gradients sum millions of cancelling terms (d1_out's: 128^3 a
    # channel) and differ between two f32 summation orders by percents of
    # their norm: a tensor outside the bound above is held, as phase 10 holds
    # the decoder, against the same step in float64 on the card, the card
    # within twice the larger of the CPU's distance to it and the witness
    ref = f64_step_gradients(cpu, x, masks, valid)
    outside = [n for n in g_cpu if ((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm().clamp_min(
        1e-30)).item() > bound_tensor]
    per = {n: (((g_gpu[n].double() - ref[n]).norm() / ref[n].norm()).item(),
               ((g_cpu[n].double() - ref[n]).norm() / ref[n].norm()).item()) for n in outside}
    over = {n: v for n, v in per.items()
            if v[0] > STEP_WITNESS_FACTOR * max(v[1], w_worst[0])}
    log(f"  outside {bound_tensor:.3e}, against the step in float64 on the card, "
        f"||g - g_f64|| / ||g_f64|| (card, CPU): {per}; over {STEP_WITNESS_FACTOR} times "
        f"the larger of the CPU's and the witness's {w_worst[0]:.3e}: {over}")
    if over:
        raise AssertionError("training step GPU vs CPU outside its bounds")


def f64_step_gradients(cpu, x, masks, valid):
    """``step_gradients`` of a copy of the CPU model in float64 on the card,
    as CPU tensors (the step has dropout 0)."""
    model = copy.deepcopy(cpu).to("cuda").double()
    model.compute_dtype = torch.float64
    with float64_plain():
        _, grads = step_gradients(model, x.double(), masks.double(), valid.double())
    return grads


def phase_zoo(ops, tmp):
    """Phase 13: RFNet, then RobustMseg, as phase 12 drives the family:
    both entry points at full width with no kernel launched, two identical
    training runs with equal bits, and card against CPU in f32. Returns
    {model: (evaluation numbers, training numbers)}."""
    numbers = {}
    for model in ("RFNet", "RobustMseg"):
        log(f" (a) {model}: evaluation, 16 images then 48 timed, B={EVAL_B}, bf16; no "
            f"kernel launched")
        _, ev = phase_eval_slice(ops, tmp, model=model)
        log(f" (b) {model}: training, --indices 0,1, {TRAIN_SET} patches, 1 epoch, "
            f"B={TRAIN_B}, bf16, the data set resident; no kernel launched; the two runs "
            f"equal bit for bit")
        _, tr = phase_train_slice(ops, tmp, model=model, repeat=True)
        log(f"  {model}: evaluation {ev['images_per_s']:.3f} images/s (batch seconds "
            f"{ev['batch_seconds']:.4f}, peak {ev['peak_bytes']} bytes); training "
            f"{tr['patches_per_s']:.3f} patches/s (step seconds {tr['step_seconds']:.4f}, "
            f"peak {tr['peak_bytes']} bytes)")
        torch.cuda.empty_cache()
        log(f" (c) {model}: whole model, B=1 f32, card vs CPU")
        phase_whole_model(model=model)
        log(f" (d) {model}: one training step, B=1 f32, card vs CPU (the CPU's convolutions "
            f"PyTorch's own, without oneDNN)")
        with torch.backends.mkldnn.flags(enabled=False):
            phase_train_step(model=model)
        torch.cuda.empty_cache()
        numbers[model] = (ev, tr)
    return numbers


def phase_conv_family(ops, tmp):
    """Phase 12: MMVit2, then mmformer, through both entry points at full
    width, and card against CPU in f32. Returns {model: (evaluation
    numbers, training numbers)}."""
    numbers = {}
    for model in ("MMVit2", "mmformer"):
        want = MODEL_LAUNCHES[model]
        log(f" (a) {model}: evaluation, 16 images then 48 timed, B={EVAL_B}, bf16; per forward "
            f"K1f {want['k1']}, K2f {want['k2']}, K3 {want['k3_eval']}, K3b 0, K4 0")
        _, ev = phase_eval_slice(ops, tmp, model=model)
        log(f" (b) {model}: training, --indices 0,1, {TRAIN_SET} patches, 1 epoch, "
            f"B={TRAIN_B}, bf16, dropout {RATE}, the data set resident; per step K1f "
            f"{want['k1']}, K1b {want['k1']}, K2f {want['k2']}, K2b {want['k2']}, K3 "
            f"{want['k3_step']}, K3b {want['k3_step']}; the two runs equal bit for bit")
        _, tr = phase_train_slice(ops, tmp, model=model, repeat=True)
        log(f"  {model}: evaluation {ev['images_per_s']:.3f} images/s (batch seconds "
            f"{ev['batch_seconds']:.4f}, peak {ev['peak_bytes']} bytes); training "
            f"{tr['patches_per_s']:.3f} patches/s (step seconds {tr['step_seconds']:.4f}, "
            f"peak {tr['peak_bytes']} bytes)")
        torch.cuda.empty_cache()
        log(f" (c) {model}: whole model, B=1 f32, GPU kernels vs CPU plain versions")
        phase_whole_model(model=model)
        log(f" (d) {model}: one training step, B=1 f32, dropout 0, GPU kernels vs CPU "
            f"plain versions")
        phase_train_step(model=model)
        torch.cuda.empty_cache()
        numbers[model] = (ev, tr)
    return numbers


def decoder_inputs(b, dtype, device, seed=0):
    """The decoder's inputs at the cascade's real sizes: the skips x1..x4 and
    the bottleneck x5, contiguous NCDHW as the model hands them over."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(b, 24, 3, 56, 56), (b, 48, 3, 56, 56), (b, 96, 3, 28, 28),
              (b, 192, 3, 14, 14), (b, 192, 8, 8, 8)]
    return [torch.randn(s, generator=gen).to(device=device, dtype=dtype) for s in shapes]


def seeded_decoder(**kwargs):
    from corrifnet_tpu_torch.models.decoder import DecoderFuse

    dec = DecoderFuse(**kwargs)
    gen = torch.Generator().manual_seed(0)
    for m in dec.modules():
        if m is not dec and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return dec


def decoder_step(dec, xs, scale=1.0):
    """Output and the gradients of mean(out^2) w.r.t. the parameters and the
    inputs, by name."""
    leaves = [(x * scale).detach().requires_grad_() for x in xs]
    out = dec(*leaves)
    names = [n for n, _ in dec.named_parameters()] + [f"x{i + 1}" for i in range(5)]
    grads = torch.autograd.grad((out.float() ** 2).mean(),
                                list(dec.parameters()) + leaves)
    return out.detach(), dict(zip(names, (g.detach() for g in grads)))


def xla_epilogue(y):
    """K3's function with single-pass statistics on channels-last ``y``: the
    standard stage's epilogue as the JAX package composes it off the TPU,
    the same statistics as the lean stages' ``relu_in_stats``."""
    from corrifnet_tpu_torch.nn.leandec import relu_in_stats

    ys, a, b = relu_in_stats(y.permute(0, 4, 1, 2, 3))
    return (ys * a + b).permute(0, 2, 3, 4, 1)


@contextlib.contextmanager
def float64_plain():
    """While it runs, the kernels' call sites on the models' paths are given
    their plain versions (at rate 0) and every ``.float()`` is a
    ``.double()``: a float64 yardstick on the card."""
    from corrifnet_tpu_torch import ops
    from corrifnet_tpu_torch.models import mmvit2, mmvit4
    from corrifnet_tpu_torch.nn import conv as tconv
    from corrifnet_tpu_torch.nn import transformer

    def plain_attention_qkv(qkv, scale, rate=0.0, philox=None):
        return ops.attention_plain(*qkv.permute(2, 0, 3, 1, 4).unbind(0), scale)

    sites = [(tconv, "relu_instancenorm", ops.relu_instancenorm_plain),
             (mmvit2, "correlation_fusion", ops.correlation_fusion_plain),
             (mmvit4, "correlation_fusion", ops.correlation_fusion_plain),
             (transformer, "fused_attention_qkv", plain_attention_qkv)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        torch.Tensor.float = to_float
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def f64_decoder_gradients(dec, xs):
    """``decoder_step``'s gradients of ``dec`` in float64 on the card, as CPU
    tensors."""
    with float64_plain():
        _, grads = decoder_step(dec.double(), [x.double() for x in xs])
    return {n: g.cpu() for n, g in grads.items()}


def phase_decoder():
    """The default decoder at the cascade's real sizes (skips (1, 24/48/96/192,
    3, 56/56/28/14, 56/56/28/14), bottleneck (1, 192, 8, 8, 8)), f32 with
    TF32 off, the gradients of mean(out^2) w.r.t. every parameter and input:

    * depth-fused against the plain resize-then-conv chain, both standard:
      the output within atol 1e-4 + rtol 1e-3 (tests/test_depthfuse.py:130),
      each gradient tensor's relative L2 distance within twice the worst the
      plain chain shows against itself under a 1e-6 change of its input;
    * lean against the standard fused chain, both with the single-pass
      epilogue (K3 computes its variance in two passes, the lean stages in
      one, as the JAX package does): every parameter gradient within 2e-5 of
      its largest entry (tests/test_lean_decoder.py:67);
    * the fused lean decoder on the card against the CPU: the output within
      1e-4; the gradients against the same decoder in float64 on the card,
      the whole gradient no further than twice the larger of the CPU's
      distance and the witness above, each tensor no further than twice the
      larger of its CPU's distance, the whole witness and its own witness.

    Then, in bf16 at B=4: the device time (profiler) and the peak memory of
    one forward and backward for the plain chain, the fused standard chain
    and the fused lean decoder."""
    from corrifnet_tpu_torch.nn import conv as tconv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xs = decoder_inputs(1, torch.float32, "cuda")
    plain = seeded_decoder(fuse_depth=False).cuda()
    state = plain.state_dict()

    def built(**kwargs):
        dec = seeded_decoder(**kwargs)
        dec.load_state_dict(state)
        return dec.cuda()

    out_p, g_p = decoder_step(plain, xs)
    _, g_w = decoder_step(plain, xs, 1 + 1e-6)
    out_f, g_f = decoder_step(built(lean=False), xs)
    close = (out_f - out_p).abs() <= 1e-4 + 1e-3 * out_p.abs()
    whole, med, worst = gradient_agreement(g_f, g_p)
    w_whole, _, w_worst = gradient_agreement(g_w, g_p)
    # each tensor's own witness, the floor f32 rounding sets for it
    w_tensor = {n: ((g_w[n] - g_p[n]).norm() / g_p[n].norm().clamp_min(1e-30)).item()
                for n in g_p}
    log(f"  fused against plain: max |out diff| {(out_f - out_p).abs().max().item():.3e} "
        f"(bound 1e-4 + 1e-3 rel: {bool(close.all())}); gradients ||fused - plain|| / "
        f"||plain||: whole {whole:.3e}, per tensor median {med:.3e}, worst {worst[0]:.3e} "
        f"at {worst[1]}; witness (plain, input x (1 + 1e-6)) whole {w_whole:.3e}, worst "
        f"{w_worst[0]:.3e} at {w_worst[1]}")
    if not (close.all() and whole <= STEP_WITNESS_FACTOR * w_whole
            and worst[0] <= STEP_WITNESS_FACTOR * w_worst[0]):
        raise AssertionError("depth-fused decoder against the plain chain outside its bounds")
    del plain, g_p, g_w, g_f

    standard = tconv.relu_instancenorm
    tconv.relu_instancenorm = xla_epilogue
    try:
        out_s, g_s = decoder_step(built(lean=False), xs)
        out_l, g_l = decoder_step(built(lean=True), xs)
    finally:
        tconv.relu_instancenorm = standard
    params = [n for n in g_s if not n.startswith("x")]
    lean_err = {n: rel_max(g_l[n], g_s[n]) for n in params}
    worst_l = max(lean_err, key=lean_err.get)
    out_err = (out_l - out_s).abs().max().item()
    log(f"  lean against standard (single-pass epilogue): max |out diff| {out_err:.3e}; "
        f"worst parameter gradient max |lean - standard| / max |standard| "
        f"{lean_err[worst_l]:.3e} at {worst_l} (bound {LEAN_GRAD_RTOL})")
    if not (out_err <= 1e-6 and lean_err[worst_l] <= LEAN_GRAD_RTOL):
        raise AssertionError("lean decoder against the standard chain outside its bounds")
    del g_s, g_l

    cpu = seeded_decoder(lean=True)
    cpu.load_state_dict(state)
    out_g, g_g = decoder_step(built(lean=True), xs)
    out_c, g_c = decoder_step(cpu, [x.cpu() for x in xs])
    g_g = {n: g.cpu() for n, g in g_g.items()}
    diff = (out_g.cpu() - out_c).abs().max().item()
    # the yardstick: the same decoder in float64 on the card (plain K3, every
    # .float() a .double(), cuDNN in f64). Its bias gradients sum millions of
    # terms that cancel (a conv's bias before InstanceNorm), so the card's
    # and the CPU's f32 sums differ by percents of them while both stay as
    # near the true gradient: the whole gradient within twice the larger of
    # the CPU's distance to f64 and the witness above (what the gradient
    # moves under a 1e-6 change of the input: the floor f32 rounding sets),
    # each tensor within twice the larger of its CPU's distance, the whole
    # witness and its own witness (RFM5_reduce.bias moves by 0.52% under that
    # change, the whole gradient by 0.14%, since the plain chain's trilinear
    # backward no longer adds with atomics)
    ref = f64_decoder_gradients(built(lean=True), xs)
    card, med, worst = gradient_agreement(g_g, ref)
    host, host_med, host_worst = gradient_agreement(g_c, ref)
    per = {n: (((g_g[n].double() - ref[n]).norm() / ref[n].norm()).item(),
               ((g_c[n].double() - ref[n]).norm() / ref[n].norm()).item()) for n in ref}
    over = {n: v for n, v in per.items()
            if v[0] > STEP_WITNESS_FACTOR * max(v[1], w_whole, w_tensor.get(n, 0.0))}
    log(f"  fused lean, card against CPU: max |out diff| {diff:.3e} (bound "
        f"{WHOLE_MODEL_ATOL}); ||g - g_f64|| / ||g_f64||: card whole {card:.3e}, median "
        f"{med:.3e}, worst {worst[0]:.3e} at {worst[1]}; CPU whole {host:.3e}, median "
        f"{host_med:.3e}, worst {host_worst[0]:.3e} at {host_worst[1]}; the card's "
        f"witness {w_whole:.3e}; tensors over {STEP_WITNESS_FACTOR} times the larger: "
        f"{over}")
    if not (out_g.shape == (1, 3, 1, 224, 224) and bool(torch.isfinite(out_g).all())
            and diff <= WHOLE_MODEL_ATOL and card <= STEP_WITNESS_FACTOR * max(host, w_whole)
            and not over):
        raise AssertionError("fused lean decoder, card against CPU, outside its bounds")
    del cpu, g_g, g_c, ref
    torch.cuda.empty_cache()

    xs = decoder_inputs(TRAIN_B, torch.bfloat16, "cuda")
    for label, kwargs in (("plain chain (fuse_depth off; lean needs it)",
                           {"fuse_depth": False}),
                          ("fused, lean off", {"lean": False}),
                          ("fused, lean on", {"lean": True})):
        dec = built(**kwargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        decoder_step(dec, xs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = profiled_device_ms(lambda: decoder_step(dec, xs), launches=5)
        log(f"  B={TRAIN_B} bf16 forward + backward, {label}: device {ms:.3f} ms "
            f"(profiler, 5 calls); peak memory {peak} bytes, {peak - held} above the "
            f"{held} held before")
        del dec
        torch.cuda.empty_cache()


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
    log(f"  nvcc build + load of {len(CUDA_SOURCES)} sources "
        f"{time.perf_counter() - t0:.2f} s")
    for report in sorted(BUILD_DIR.glob("*.log")):
        log(f"  {report.name}: " + "; ".join(ptxas_summary(report.read_text())))
    check_tensor_core_kernels(BUILD_DIR)

    log("phase 3: kernels against their plain versions")
    t0 = time.perf_counter()
    results = phase_kernels(ops)
    log(f"  phase 3 took {time.perf_counter() - t0:.2f} s (Triton compiles included)")

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            log("phase 4: evaluation slice, 16 images, B=8, bf16")
            eval_launches, eval_off = phase_eval_slice(ops, tmp)
            log("phase 5: training slice, 40 patches, 1 epoch, B=4, bf16, dropout 0.1")
            launches, train_off = phase_train_slice(ops, tmp)
            log("phase 8: the fused configuration (pallas_fused_blocks) through "
                "both entry points, same sizes")
            fused_eval_launches, eval_on = phase_eval_slice(ops, tmp, fused=True)
            fused_launches, train_on = phase_train_slice(ops, tmp, fused=True)
            log("phase 11: the training entry point's run-level features, 40 patches, "
                "2 epochs, B=4, bf16, dropout 0.1")
            phase_run_level(ops, tmp)
            log("phase 12: the conv-encoder family, MMVit2 then mmformer, through both "
                "entry points and card against CPU")
            phase_conv_family(ops, tmp)
            log("phase 13: RFNet, then RobustMseg, through both entry points and card "
                "against CPU")
            phase_zoo(ops, tmp)
        finally:
            os.chdir(here)
    for counts, fused_counts in ((eval_launches, fused_eval_launches),
                                 (launches, fused_launches)):
        moved = {k: (v, fused_counts[k]) for k, v in counts.items()
                 if k not in K4_KERNELS and fused_counts[k] != v}
        if moved:
            raise AssertionError(f"K1-K3 launches differ with the flag on: {moved}")
    compare_line("evaluation images/s", "", eval_off["images_per_s"],
                 eval_on["images_per_s"])
    compare_line("evaluation peak memory", "GiB", eval_off["peak_bytes"] / 2 ** 30,
                 eval_on["peak_bytes"] / 2 ** 30)
    compare_line("training median step", "s", train_off["step_seconds"],
                 train_on["step_seconds"])
    compare_line("training patches/s", "", train_off["patches_per_s"],
                 train_on["patches_per_s"])
    compare_line("training peak memory", "GiB", train_off["peak_bytes"] / 2 ** 30,
                 train_on["peak_bytes"] / 2 ** 30)
    launches = {**launches, **{k: fused_launches[k] for k in K4_KERNELS}}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    log("phase 6: whole model, B=1 f32, GPU kernels vs CPU plain versions")
    phase_whole_model()
    log("phase 7: one training step, B=1 f32, GPU kernels vs CPU plain versions, "
        "the decoder lean by the batch rule")
    phase_train_step()
    log("phase 7, again with decoder_lean=false: the fused standard chain")
    phase_train_step(decoder_lean=False)
    log("phase 9: fused, GPU kernels vs CPU plain versions, f32: bottleneck train "
        "steps, then the whole model at B=1")
    phase_fused_block()
    phase_whole_model(fused=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("phase 10: the decoder at the cascade's real sizes, fused and lean against "
        "the plain chain (f32, B=1), card against CPU; device time and peak memory "
        "of its forward and backward (bf16, B=4)")
    phase_decoder()
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
