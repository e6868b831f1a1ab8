"""The port's kernels against their plain versions on an NVIDIA GPU.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import). This file imports no
jax, so it runs on a machine without it, from the root of the checkout:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Bounds as in chip_smoke.py: f32 against the plain version in f32 (sums in
another order); bf16 against the plain version run in f32 on the same
bf16 inputs. Dropout is compared element by element: the plain version is
given ``philox_keep_mask`` of the key the kernel is given.
"""

from __future__ import annotations

import pytest
import torch

from corrifnet_tpu_torch import ops
from corrifnet_tpu_torch.testing import rel_max

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, gen, shift=0.0):
    return torch.randn(shape, generator=gen, device="cuda") + shift


def _bf16_ulp(ref):
    _, exp = torch.frexp(ref.abs())
    return torch.where(ref == 0, torch.zeros_like(ref),
                       torch.ldexp(torch.ones_like(ref), exp - 8))


def _check(wrapper, plain, args, extra, atol, rtol, bf16_bound=None):
    before = wrapper.launches
    got = wrapper(*args, *extra)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(*args, *extra)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all())

    args16 = [a.to(torch.bfloat16) for a in args]
    got16 = wrapper(*args16, *extra).float()
    ref = plain(*(a.float() for a in args16), *extra)
    torch.cuda.synchronize()
    bound = (bf16_bound if bf16_bound is not None
             else 2 * _bf16_ulp(ref) + atol + rtol * ref.abs())
    assert bool(((got16 - ref).abs() <= bound).all())


@pytest.mark.parametrize("shape", [(3, 1, 4, 8), (3, 2, 64, 512), (3, 8, 512, 512)])
def test_correlation_kernel(cuda, shape):
    args = [_randn(shape, cuda) for _ in range(3)]
    _check(ops.correlation_fusion, ops.correlation_fusion_plain, args, (), 1e-6, 0.0)


@pytest.mark.parametrize("shape", [(1, 1, 64, 64), (2, 8, 512, 64), (1, 8, 2048, 64)])
def test_attention_kernel(cuda, shape):
    args = [_randn(shape, cuda) for _ in range(3)]
    _check(ops.fused_attention, ops.attention_plain, args, (0.125,), 2e-5, 0.0,
           bf16_bound=2e-2)


@pytest.mark.parametrize("shape", [
    (1, 1, 1, 1, 8), (2, 3, 5, 7, 20), (2, 8, 8, 8, 192), (2, 3, 56, 56, 24),
    (1, 64, 64, 64, 16), (1, 128, 128, 128, 8),
])
def test_relu_instancenorm_kernel(cuda, shape):
    args = [_randn(shape, cuda, shift=0.2)]
    _check(ops.relu_instancenorm, ops.relu_instancenorm_plain, args, (), 1e-5, 1e-4)


# K4: every output against the plain version as max |difference| over
# max |plain|. f32: sums in another order (up to 37,632 rows or 9 x 512
# channels), 2e-5. bf16: the plain version rounds at the same points with
# f32 accumulation, so values differ by a bf16 ulp where a sum lands on
# the other side of a rounding boundary, 1e-2; the f32 statistics see the
# same rounded inputs, 1e-4.
K4_F32, K4_BF16, K4_BF16_STATS = 2e-5, 1e-2, 1e-4

_K4_CASES = {
    # name: (taps, x shape, co, prologue)
    "pw_tail_odd": (1, (48, 33), 40, True),
    "pw_plain_small": (1, (700, 64), 256, False),
    "pw_layer1": (1, (9408, 64), 64, False),
    "pw_expand": (1, (588, 512), 2048, True),
    "pw_widest": (1, (588, 2048), 512, False),
    "c3_tail_odd": (9, (2, 7, 9, 16), 24, True),
    "c3_layer1": (9, (3, 56, 56, 64), 64, True),
    "c3_layer4": (9, (12, 7, 7, 512), 512, True),
}


def _k4_inputs(case, gen, dtype):
    taps, xs, co, prologue = _K4_CASES[case]
    ci = xs[-1]
    x = _randn(xs, gen).to(dtype)
    ws = (ci, co) if taps == 1 else (3, 3, ci, co)
    w = (_randn(ws, gen) / (taps * ci) ** 0.5).to(dtype)
    a = (torch.rand(ci, generator=gen, device="cuda") + 0.5) if prologue else None
    b = 0.3 * _randn((ci,), gen) if prologue else None
    dy = _randn((*xs[:-1], co), gen).to(dtype)
    ds, dq = 0.3 * _randn((co,), gen), 0.01 * _randn((co,), gen)
    return taps, (x, w, a, b), (dy, ds, dq)


def _k4_run(fn, args, cotangents):
    leaves = [t.detach().clone().requires_grad_() for t in args if t is not None]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, cotangents)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_K4_CASES))
def test_fused_conv_kernels(cuda, case, dtype):
    taps, args, cotangents = _k4_inputs(case, cuda, dtype)
    name = "pointwise_conv_stats" if taps == 1 else "conv3x3_fma_relu_stats"
    fwd, bwd = ops.KERNELS[name], ops.KERNELS[name + "_bwd"]
    before = fwd.launches, bwd.launches
    out, grads = _k4_run(fwd, args, cotangents)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)

    x, w, a, b = args
    want = getattr(ops, name + "_plain")(x, w, a, b)
    want_grads = getattr(ops, name + "_backward_plain")(x, w, a, b, out[0].detach(),
                                                        *cotangents)
    want_grads = [g for g in want_grads if g is not None]
    bound, stats_bound = ((K4_F32, K4_F32) if dtype == torch.float32
                          else (K4_BF16, K4_BF16_STATS))
    assert out[0].dtype == dtype and out[1].dtype == out[2].dtype == torch.float32
    assert rel_max(out[0], want[0]) <= bound
    assert rel_max(out[1], want[1]) <= stats_bound
    assert rel_max(out[2], want[2]) <= stats_bound
    assert len(grads) == len(want_grads)
    for got, ref in zip(grads, want_grads):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert rel_max(got, ref) <= bound

    # no atomics: a second run gives the same bits; without the statistics
    # (evaluation) y is the same bits too
    out2, grads2 = _k4_run(fwd, args, cotangents)
    assert all(torch.equal(u, v) for u, v in zip((*out, *grads), (*out2, *grads2)))
    with torch.no_grad():
        y3, s3, q3 = fwd(x, w, a, b, stats=False)
    assert torch.equal(y3, out[0]) and s3 is None and q3 is None


@pytest.mark.parametrize("stride,down", [(1, False), (1, True), (2, True)])
def test_fused_bottleneck_on_the_card_matches_the_cpu(cuda, stride, down):
    """One train step of a fused bottleneck in f32: output, running
    statistics and gradients through the kernels against the plain versions
    on the CPU, 1e-4 of each tensor's largest entry, on data with no ReLU
    input within rounding of 0 (``testing.well_conditioned_block``)."""
    import copy

    from corrifnet_tpu_torch.models.resnet3d import Bottleneck3D
    from corrifnet_tpu_torch.testing import block_train_step, well_conditioned_block

    cin = 64 if down else 128
    cpu, x, want, _ = well_conditioned_block(
        lambda: Bottleneck3D(cin, 32, stride, down, pallas_fused=True),
        (2, cin, 3, 14, 14))
    got = block_train_step(copy.deepcopy(cpu).to("cuda"), x)
    for key, ref in want.items():
        assert rel_max(got[key], ref) <= 1e-4, key


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _randn((1, 1, 64, 64), cuda)
    with pytest.raises(ValueError):
        ops.fused_attention(x, x, x.transpose(2, 3), 0.125)  # not contiguous
    with pytest.raises(ValueError):
        ops.fused_attention(*(_randn((1, 1, 64, 32), cuda) for _ in range(3)), 0.125)
    with pytest.raises(ValueError):
        ops.correlation_fusion(x, x, x)  # not (3, B, N, C)
    with pytest.raises(ValueError):
        ops.relu_instancenorm(x.half())


# ---------------------------------------------------------------- backward


@pytest.mark.parametrize("shape", [(3, 1, 4, 8), (3, 2, 64, 512), (3, 4, 512, 512)])
def test_correlation_backward_kernel(cuda, shape):
    """K1b against the plain formulas (f32, 1e-6) and through autograd."""
    q, k, v, g = (_randn(shape, cuda) for _ in range(4))
    before = ops.correlation_fusion_bwd.launches
    got = ops.correlation_fusion_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert ops.correlation_fusion_bwd.launches == before + 1
    want = ops.correlation_fusion_backward_plain(q, k, v, g)
    for a, b in zip(got, want):
        assert bool(((a - b).abs() <= 1e-6 + 1e-6 * b.abs()).all())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.correlation_fusion(*leaves).backward(g)
    assert ops.correlation_fusion_bwd.launches == before + 2
    for leaf, b in zip(leaves, got):
        assert torch.equal(leaf.grad, b)
    got16 = ops.correlation_fusion_bwd(*(t.bfloat16() for t in (q, k, v, g)))
    ref = ops.correlation_fusion_backward_plain(
        *(t.bfloat16().float() for t in (q, k, v, g)))
    for a, b in zip(got16, ref):
        assert bool(((a.float() - b).abs() <= 2 * _bf16_ulp(b) + 1e-6).all())


def _plain_attention_grads(q, k, v, g, scale, rate, keep):
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = ops.attention_plain(*leaves, scale, rate, keep)
    return out, torch.autograd.grad(out, leaves, g.float())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(1, 1, 64, 64), (2, 3, 128, 64), (1, 8, 512, 64)])
def test_attention_forward_backward_kernels(cuda, shape, rate):
    """K2f (with dropout and lse) and K2b against the plain version and its
    autograd backward under the same Philox mask: f32 2e-5 on the output,
    2e-5 * max|grad| + 1e-6 on the gradients (sums in another order)."""
    from corrifnet_tpu_torch.ops import attention as t_attn

    b, h, n, _ = shape
    q, k, v, g = (_randn(shape, cuda) for _ in range(4))
    philox = (1234, 77)
    keep = None
    if rate > 0:
        keep = ops.philox_keep_mask(*philox, b * h, n, rate, "cuda").view(b, h, n, n)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = ops.fused_attention.launches, ops.fused_attention_bwd.launches
    out = ops.fused_attention(*leaves, 0.125, rate, philox)
    out.backward(g)
    torch.cuda.synchronize()
    assert ops.fused_attention.launches == f0 + 1
    assert ops.fused_attention_bwd.launches == b0 + 1
    want, grads = _plain_attention_grads(q, k, v, g, 0.125, rate, keep)
    assert bool(((out - want).abs() <= 2e-5).all())
    for leaf, ref in zip(leaves, grads):
        bound = 2e-5 * ref.abs().max() + 1e-6
        assert bool(((leaf.grad - ref).abs() <= bound).all())
    # the lse residual: log of the undropped row sums
    _, lse = t_attn._launch_fwd(q, k, v, 0.125, rate, *philox, True)
    s = torch.einsum("bhnd,bhmd->bhnm", q, k) * 0.125
    assert bool(((lse - torch.logsumexp(s, dim=-1)).abs() <= 1e-5).all())
    # bf16 against the plain version in f32 on the same bf16 inputs
    q16, k16, v16, g16 = (t.bfloat16() for t in (q, k, v, g))
    leaves16 = [t.clone().requires_grad_() for t in (q16, k16, v16)]
    out16 = ops.fused_attention(*leaves16, 0.125, rate, philox)
    out16.backward(g16)
    want16, grads16 = _plain_attention_grads(q16, k16, v16, g16, 0.125, rate, keep)
    assert bool(((out16.float() - want16).abs() <= 2e-2).all())
    for leaf, ref in zip(leaves16, grads16):
        assert bool(((leaf.grad.float() - ref).abs() <= 2e-2 * ref.abs().max()).all())


def test_attention_backward_is_bitwise_repeatable(cuda):
    shape = (2, 8, 512, 64)
    q, k, v, g = (_randn(shape, cuda).bfloat16() for _ in range(4))
    from corrifnet_tpu_torch.ops import attention as t_attn

    out, lse = t_attn._launch_fwd(q, k, v, 0.125, 0.1, 5, 6, True)
    first = ops.fused_attention_bwd(q, k, v, out, lse, g, 0.125, 0.1, (5, 6))
    again = ops.fused_attention_bwd(q, k, v, out, lse, g, 0.125, 0.1, (5, 6))
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_kernel_keep_mask_equals_philox_keep_mask(cuda):
    """The mask the kernels' device function writes, against the plain
    PyTorch Philox: exact; keep rate within 4 sigma of 0.9."""
    from corrifnet_tpu_torch.ops.attention import kernel_keep_mask

    n, rate = 512, 0.1
    got = kernel_keep_mask(99, 3, 5, 2, n, rate)
    want = ops.philox_keep_mask(99, 3, 2, n, rate, "cuda", bh0=5)
    assert torch.equal(got, want)
    sigma = (rate * (1 - rate) / got.numel()) ** 0.5
    assert abs(got.float().mean().item() - (1 - rate)) <= 4 * sigma
    assert not torch.equal(got[0], got[1])


def test_backward_wrappers_never_take_the_plain_version(cuda, monkeypatch):
    """On CUDA tensors the backward of each autograd.Function launches its
    kernel: with the plain versions made to raise, gradients still come."""
    from corrifnet_tpu_torch.ops import attention as t_attn
    from corrifnet_tpu_torch.ops import correlation as t_corr

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(t_corr, "correlation_fusion_plain", boom)
    monkeypatch.setattr(t_corr, "correlation_fusion_backward_plain", boom)
    monkeypatch.setattr(t_attn, "attention_plain", boom)
    monkeypatch.setattr(t_attn, "philox_keep_mask", boom)
    x = [_randn((3, 1, 64, 64), cuda).requires_grad_() for _ in range(3)]
    ops.correlation_fusion(*x).sum().backward()
    y = [_randn((1, 1, 64, 64), cuda).requires_grad_() for _ in range(3)]
    ops.fused_attention(*y, 0.125, 0.1, (1, 2)).sum().backward()
    torch.cuda.synchronize()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in x + y)
    with pytest.raises(ValueError):
        ops.correlation_fusion_bwd(x[0].detach(), x[1].detach(), x[2].detach(),
                                   x[0].detach().transpose(2, 3))
    with pytest.raises(ValueError):
        ops.fused_attention(*y, 0.125, 0.1)  # dropout without a Philox key


@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 20), (1, 16, 16, 16, 64)])
def test_relu_instancenorm_gradient(cuda, shape):
    """K3 under autograd: kernel forward, plain-formula backward, against
    autograd through the plain version (f32, 1e-5 + 1e-4 rel)."""
    x = _randn(shape, cuda, shift=0.2)
    g = _randn(shape, cuda)
    a = x.clone().requires_grad_()
    ops.relu_instancenorm(a).backward(g)
    b = x.clone().requires_grad_()
    ops.relu_instancenorm_plain(b).backward(g)
    assert bool(((a.grad - b.grad).abs() <= 1e-5 + 1e-4 * b.grad.abs()).all())


@pytest.mark.parametrize("src,dst", [((3, 14, 14), 16), ((3, 28, 28), 32),
                                     ((3, 56, 56), 64), ((3, 56, 56), 128)])
def test_resize_nearest_gradient_on_the_card_equals_the_cpu(cuda, src, dst):
    """The decoder's skip resizes: forward bitwise equal to the CPU's, the
    backward (the port's own, nn/resize.py) within 1e-5 of the largest
    gradient. PyTorch's CUDA backward of the same op misses this bound by
    four orders of magnitude at 28 -> 32, 56 -> 64 and 56 -> 128."""
    from corrifnet_tpu_torch.nn import resize_nearest

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 4, *src), generator=gen)
    g = torch.randn((1, 4, dst, dst, dst), generator=gen)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaf = x.to(dev).requires_grad_()
        out = resize_nearest(leaf, (dst,) * 3)
        grads[dev] = (out.detach().cpu(), torch.autograd.grad(out, leaf, g.to(dev))[0].cpu())
    assert torch.equal(grads["cpu"][0], grads["cuda"][0])
    err = (grads["cpu"][1] - grads["cuda"][1]).abs().max().item()
    assert err <= 1e-5 * grads["cpu"][1].abs().max().item(), err


@pytest.mark.parametrize("fused", [False, True])
def test_model_forward_runs_every_kernel(cuda, fused):
    from corrifnet_tpu_torch.models import create_model

    model = create_model("MMVit4", dtype=torch.bfloat16, device="cuda",
                         pallas_fused_blocks=fused)
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    with torch.no_grad():
        out = model(torch.zeros(2, 3, 3, 64, 64, device="cuda"))
    torch.cuda.synchronize()
    assert out.shape == (2, 3, 1, 224, 224) and bool(torch.isfinite(out).all())
    assert {n: w.launches for n, w in ops.KERNELS.items()} == {
        "correlation_fusion": 1, "correlation_fusion_bwd": 0,
        "fused_attention": 4, "fused_attention_bwd": 0, "relu_instancenorm": 27,
        "pointwise_conv_stats": 108 * fused, "pointwise_conv_stats_bwd": 0,
        "conv3x3_fma_relu_stats": 39 * fused, "conv3x3_fma_relu_stats_bwd": 0}
