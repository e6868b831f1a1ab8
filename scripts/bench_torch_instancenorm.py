#!/usr/bin/env python3
"""Device time of K3 and K3b (csrc/instancenorm.cu) at the decoder's shapes,
on one NVIDIA GPU, in bf16.

    python3 scripts/bench_torch_instancenorm.py [--plans] [--parts]

Default: per shape of one B=4 training step and one B=8 evaluation forward
(chip_smoke.k3_shapes), the plan's regime, K3's and (B=4) K3b's device time
from profiler traces of 20 calls, the bytes bound and, as a yardstick of
what the card's memory gives, ``x.clone()`` (one read and one write of x);
then the sums over the 27 calls.

``--plans``: the same calls under other plans: 1, 2, 4 and 8 samples a
round in the grid regime, and the cluster regime off (every multi-chunk
plan a grid) or at 4 blocks a cluster.

``--parts``: which part of the kernel takes the time: copies of the source
with one part removed (the grid barrier; phase 3's stores; the copies of
the kept rows to shared memory), each built with nvcc under build/, timed
by CUDA events at the 128^3 volume. Their results are wrong by
construction; only their times mean something.

Fails without a GPU. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from corrifnet_tpu_torch import ops  # noqa: E402
from corrifnet_tpu_torch.ops import instancenorm as t  # noqa: E402
from corrifnet_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path  # noqa: E402

BASE_PLAN = t.plan


def inputs(shape, gen):
    x = cs.randn(shape, gen, 0.2).bfloat16()
    g = cs.randn(shape, gen).bfloat16()
    _, mean, rstd = t._launch(x, 1e-5)
    return x, g, mean, rstd


def times(x, g, mean, rstd, backward):
    f = cs.profiled_device_ms(lambda: t._launch(x, 1e-5))
    if not backward:
        return f, 0.0
    return f, cs.profiled_device_ms(lambda: ops.relu_instancenorm_bwd(x, g, mean, rstd))


def samples_a_round(per_round):
    """ops.instancenorm.plan with ``per_round`` samples a round wherever it
    makes a grid, the chunks and the rows kept on chip as it makes them."""
    def plan(b, n, c, itemsize, backward=False, max_blocks=132):
        p = BASE_PLAN(b, n, c, itemsize, backward, max_blocks)
        if p.regime != "grid":
            return p
        pr = min(b, per_round)
        chunks = max_blocks // pr
        rows = -(-n // chunks)
        chunks = -(-n // rows)
        row_bytes = 8 * -(-c // 8) * itemsize * (2 if backward else 1)
        res = min(rows, (t.SMEM_LIMIT - t.fixed_smem_bytes(c)) // row_bytes)
        return t.Plan("grid", chunks, rows, pr, -(-b // pr), res, pr * chunks,
                      t.fixed_smem_bytes(c) + res * row_bytes, b * chunks * 2 * c, 2)
    return plan


def default(gen):
    for b in (4, 8):
        fwd = bwd = bound_f = bound_b = 0.0
        for shape, calls in cs.k3_shapes(b):
            x, g, mean, rstd = inputs(shape, gen)
            f, bb = times(x, g, mean, rstd, b == 4)
            copy = cs.profiled_device_ms(lambda: x.clone())
            p = t.plan(b, x.numel() // (b * shape[-1]), shape[-1], 2)
            bf, bk = cs.bytes_bound_ms(2 * x.numel()), cs.bytes_bound_ms(3 * x.numel())
            fwd, bwd, bound_f, bound_b = fwd + calls * f, bwd + calls * bb, bound_f + calls * bf, \
                bound_b + calls * bk
            print(f"B={b} {shape} x{calls} {p.regime} ({p.chunks} chunks, {p.per_round} a "
                  f"round, {p.rounds} rounds, {p.resident_rows / p.chunk_rows:.3f} on chip): K3 "
                  f"{f:.4f} ms (bound {bf:.4f}), K3b {bb:.4f} ms (bound {bk:.4f}); x.clone() "
                  f"{copy:.4f} ms", flush=True)
        print(f"B={b} sums: K3 {fwd:.4f} ms (bound {bound_f:.4f}), K3b {bwd:.4f} ms (bound "
              f"{bound_b:.4f})", flush=True)


def plans(gen):
    for b in (4, 8):
        for shape, _ in cs.k3_shapes(b):
            x, g, mean, rstd = inputs(shape, gen)
            row = []
            variants = [(f"{pr} a round", samples_a_round(pr), 8) for pr in (1, 2, 4, 8)
                        if pr <= b]
            variants += [("no clusters", BASE_PLAN, 0), ("clusters of 4", BASE_PLAN, 4)]
            for name, plan, cluster in variants:
                t.plan, t.MAX_CLUSTER = plan, cluster
                try:
                    f, bb = times(x, g, mean, rstd, b == 4)
                    p = t.plan(b, x.numel() // (b * shape[-1]), shape[-1], 2)
                finally:
                    t.plan, t.MAX_CLUSTER = BASE_PLAN, 8
                row.append(f"{name} ({p.regime}, {p.rounds} rounds) {f:.4f}/{bb:.4f}")
            print(f"B={b} {shape} K3/K3b ms: " + "; ".join(row), flush=True)


PARTS = {
    "the plan's kernel": (),
    "without the grid barrier": (("    grid_barrier(p.barrier);", "    __syncthreads();"),),
    "without phase 3's stores": (
        ("store8<T, kVec>(dst, f, ch0, c);", "if (f[0] == 12345.f) store8<T, kVec>(dst, f, ch0, c);"),
        ("store8<T, kVec>(db", "if (fx[0] == 12345.f) store8<T, kVec>(db")),
    "without the copies to shared memory": (("copy_async(keep", "if (row < 0) copy_async(keep"),
                                             ("copy_async(slot", "if (row < 0) copy_async(slot")),
}


def parts(gen):
    src = (ROOT / "corrifnet_tpu_torch" / "csrc" / "instancenorm.cu").read_text()
    out = ROOT / "build" / "bench_instancenorm"
    out.mkdir(parents=True, exist_ok=True)

    def build(item):
        i, (name, edits) = item
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: '{old}' not in the source")
            text = text.replace(old, new)
        cu, lib = out / f"part{i}.cu", out / f"libpart{i}.so"
        cu.write_text(text)
        subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(cu)], check=True,
                       capture_output=True, timeout=600)
        return name, lib

    with concurrent.futures.ThreadPoolExecutor(len(PARTS)) as pool:
        built = list(pool.map(build, enumerate(PARTS.items())))
    # only where a call's kernel outlasts its dispatch: a library loaded
    # after the profiler started can go missing from its traces, so these
    # times are by events over 20 queued calls
    shapes = [(4, 128, 128, 128, 8), (8, 128, 128, 128, 8)]
    data = {s: inputs(s, gen) for s in shapes}
    for name, lib in built:
        dll = ctypes.CDLL(str(lib))
        ints = [ctypes.c_int] * 10
        fwd, bwd = dll.corrifnet_in_fwd, dll.corrifnet_in_bwd
        fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] + ints
                        + [ctypes.c_float, ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong] + ints
                        + [ctypes.c_void_p])
        saved = t._library
        t._library = lambda fwd=fwd, bwd=bwd: (fwd, bwd)
        try:
            row = []
            for shape in shapes:
                x, g, mean, rstd = data[shape]
                f = cs.device_ms(lambda: t._launch(x, 1e-5))
                b = cs.device_ms(lambda: ops.relu_instancenorm_bwd(x, g, mean, rstd))
                row.append(f"{shape}: {f:.4f}/{b:.4f}")
        finally:
            t._library = saved
        print(f"{name}, K3/K3b ms: " + "; ".join(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch_instancenorm: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    default(gen)
    if args.plans:
        plans(gen)
    if args.parts:
        parts(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
