"""The port's kernels against their plain versions on an NVIDIA GPU.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import). This file imports no
jax, so it runs on a machine without it, from the root of the checkout:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Bounds as in chip_smoke.py: f32 against the plain version in f32 (sums in
another order); bf16 against the plain version run in f32 on the same
bf16 inputs, and for the attention kernels also against the plain version
that rounds where they round. Dropout is compared element by element: the plain version is
given ``philox_keep_mask`` of the key the kernel is given.
"""

from __future__ import annotations

import copy

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


# one shape per regime of ops.instancenorm.plan, and C = 20 (masked loads):
# one block a sample (no barrier); a grid barrier with every row on chip;
# samples in rounds; rows read again (the 128^3 volume); more samples than SMs
_K3_SHAPES = [
    (1, 1, 1, 1, 8), (2, 3, 5, 7, 20), (2, 8, 8, 8, 192), (2, 3, 56, 56, 24),
    (4, 64, 64, 64, 16), (1, 128, 128, 128, 8), (300, 4, 4, 4, 64),
]


@pytest.mark.parametrize("shape", _K3_SHAPES)
def test_relu_instancenorm_kernel(cuda, shape):
    """K3 in f32 (1e-5 + 1e-4 rel) and bf16 (2 bf16 ulps of the plain
    version in f32 on the same inputs, plus the f32 bound)."""
    args = [_randn(shape, cuda, shift=0.2)]
    _check(ops.relu_instancenorm, ops.relu_instancenorm_plain, args, (), 1e-5, 1e-4)


# K4: every output against the plain version as max |difference| over
# max |plain|. f32: sums in another order (up to 37,632 rows or 9 x 512
# channels), 2e-5. bf16: the plain version rounds at the same points with
# f32 accumulation, so values differ by a bf16 ulp where a sum lands on
# the other side of a rounding boundary, 1e-2; the f32 statistics see the
# same rounded inputs, 1e-4.
K4_F32, K4_BF16, K4_BF16_STATS = 2e-5, 1e-2, 1e-4


def _k4_model_cases(b=2):
    """Every K4a and K4c shape class of MMVit4 at batch ``b`` (the depth of
    3 folded into the rows): name -> (taps, x shape, co, prologue)."""
    r = [3 * b * side * side for side in (56, 28, 14, 7)]
    pointwise = [
        (r[0], 64, 64, False), (r[0], 64, 256, True), (r[0], 64, 256, False),
        (r[0], 256, 64, False), (r[0], 256, 128, False), (r[1], 128, 512, True),
        (r[1], 256, 512, False), (r[1], 512, 128, False), (r[1], 512, 256, False),
        (r[2], 256, 1024, True), (r[2], 512, 1024, False), (r[2], 1024, 256, False),
        (r[2], 1024, 512, False), (r[3], 512, 2048, True), (r[3], 1024, 2048, False),
        (r[3], 2048, 512, False),
    ]
    cases = {f"model_pw_{n}_{ci}_{co}{'_pro' if pro else ''}": (1, (n, ci), co, pro)
             for n, ci, co, pro in pointwise}
    for side, c in zip((56, 28, 14, 7), (64, 128, 256, 512)):
        cases[f"model_c3_{side}_{c}"] = (9, (3 * b, side, side, c), c, True)
    return cases


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
    # a block's 128 rows hold parts of three 7x7 images
    "c3_tiles_span_images": (9, (6, 7, 7, 64), 64, True),
    # few rows, deep contraction: the bf16 forward splits it (split-K)
    "pw_split": (1, (150, 1024), 256, True),
    "c3_split": (9, (2, 7, 7, 256), 256, True),
    # 256 and 2048 output columns
    "pw_256_columns": (1, (1000, 128), 256, True),
    "pw_2048_columns": (1, (300, 256), 2048, False),
    # images too wide for two halo tiles: the bf16 3x3 conv reads a shifted
    # x tile per tap instead (128 and 64 columns a block)
    "c3_wide_image": (9, (1, 4, 96, 128), 128, True),
    "c3_wide_image_64": (9, (1, 3, 128, 64), 64, True),
    **_k4_model_cases(),
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
    """K4a-d through their autograd.Function against the plain versions: f32
    the FMA kernels, bf16 the tensor-core kernels (forward, and the three
    launches of the backward); two runs give the same bits."""
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


@pytest.mark.parametrize("case", ["pw_split", "c3_split"])
def test_bf16_fused_conv_forwards_on_two_streams_keep_their_bits(cuda, case):
    """bf16 forwards with split-K and the statistics queued on two streams at
    once: each stream has its own ticket counters, so every call gives the
    bits of a call alone."""
    taps, args, _ = _k4_inputs(case, cuda, torch.bfloat16)
    fwd = ops.KERNELS["pointwise_conv_stats" if taps == 1 else "conv3x3_fma_relu_stats"]
    streams = [torch.cuda.Stream() for _ in range(2)]
    with torch.no_grad():
        want = fwd(*args)
        outs = []
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        for _ in range(16):
            for st in streams:
                with torch.cuda.stream(st):
                    outs.append(fwd(*args))
        torch.cuda.synchronize()
    for out in outs:
        assert all(torch.equal(u, v) for u, v in zip(out, want))


@pytest.mark.parametrize("case", ["pw_split", "c3_split", "pw_layer1", "c3_layer1"])
def test_bf16_fused_conv_backwards_on_two_streams_keep_their_bits(cuda, case):
    """bf16 backwards with split-K (the dx pass's in the *_split cases, the
    dw pass's, in groups, in the *_layer1 cases) queued 16 times on each of
    two streams at once: each stream has its own ticket counters, so every
    call gives the bits of a call alone."""
    taps, args, cots = _k4_inputs(case, cuda, torch.bfloat16)
    name = "pointwise_conv_stats" if taps == 1 else "conv3x3_fma_relu_stats"
    bwd = ops.KERNELS[name + "_bwd"]
    streams = [torch.cuda.Stream() for _ in range(2)]
    with torch.no_grad():
        y = ops.KERNELS[name](*args)[0]
        want = bwd(*args, y, *cots)
        outs = []
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        for _ in range(16):
            for st in streams:
                with torch.cuda.stream(st):
                    outs.append(bwd(*args, y, *cots))
        torch.cuda.synchronize()
    for out in outs:
        assert all(u is None and v is None or torch.equal(u, v) for u, v in zip(out, want))


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
    # The bf16 fused convs take any channel count and alignment: channels
    # that are not a multiple of 8, or an x that does not start on 16 bytes,
    # run the same tensor-core kernel with element loads (never the FMA
    # kernel or the plain version), with the same bits as 16-byte copies.
    x16 = _randn((48, 33), cuda).bfloat16()
    w16 = (_randn((33, 20), cuda) / 6).bfloat16()
    before = ops.pointwise_conv_stats.launches
    y, s, q = ops.pointwise_conv_stats(x16, w16)
    assert ops.pointwise_conv_stats.launches == before + 1
    want = ops.pointwise_conv_stats_plain(x16, w16)
    assert rel_max(y, want[0]) <= K4_BF16 and rel_max(s, want[1]) <= K4_BF16_STATS
    buf = _randn((1 + 300 * 64,), cuda).bfloat16()
    shifted = buf[1:].view(300, 64)  # 2 bytes past a 16-byte line
    w64 = (_randn((64, 128), cuda) / 8).bfloat16()
    for got, ref in zip(ops.pointwise_conv_stats(shifted, w64),
                        ops.pointwise_conv_stats(shifted.clone(), w64)):
        assert torch.equal(got, ref)
    # the bf16 backward likewise: the same bits with element loads
    with torch.no_grad():
        y64 = ops.pointwise_conv_stats(shifted, w64)[0]
    cots = (torch.ones_like(y64), torch.zeros(128, device="cuda"),
            torch.full((128,), 0.01, device="cuda"))
    a64, b64 = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    for got, ref in zip(ops.pointwise_conv_stats_bwd(shifted, w64, a64, b64, y64, *cots),
                        ops.pointwise_conv_stats_bwd(shifted.clone(), w64, a64, b64, y64,
                                                     *cots)):
        assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        ops.pointwise_conv_stats(x16.half(), w16.half())
    with pytest.raises(ValueError):
        ops.conv3x3_fma_relu_stats(_randn((1, 4, 4, 8), cuda).bfloat16().transpose(1, 2),
                                   _randn((3, 3, 8, 8), cuda).bfloat16(),
                                   torch.ones(8, device="cuda"), torch.zeros(8, device="cuda"))
    x = _randn((1, 1, 64, 64), cuda)
    with pytest.raises(ValueError):
        ops.fused_attention(x, x, x.transpose(2, 3), 0.125)  # not contiguous
    with pytest.raises(ValueError):  # rows start 8 bytes into a 16-byte line
        ops.fused_attention(x, x, _randn((1, 1, 64, 72), cuda)[..., 2:66], 0.125)
    with pytest.raises(ValueError):
        ops.fused_attention(*(_randn((1, 1, 64, 32), cuda) for _ in range(3)), 0.125)
    with pytest.raises(ValueError):
        ops.correlation_fusion(x, x, x)  # not (3, B, N, C)
    with pytest.raises(ValueError):
        ops.relu_instancenorm(x.half())
    with pytest.raises(ValueError):
        stats = torch.zeros((1, 64), device="cuda")
        ops.relu_instancenorm_bwd(x.half(), x.half(), stats, stats)


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


def _ulps_of_max(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / _bf16_ulp(ref.abs().max())).item()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(4, 8, 512, 64), (4, 8, 2048, 64), (8, 8, 2048, 64)])
def test_attention_bf16_tensor_core_kernels(cuda, shape, rate, packed):
    """The bf16 instantiations of K2f and K2b at the model's two shapes, at
    the training and the evaluation batch, on contiguous tensors and
    (``packed``) as the model launches them, on the strided views of a
    (B, N, 3, H, 64) projection with a cotangent in (B, N, H, 64) memory:
    within 2 bf16 ulps of the largest entry of the plain versions that round p
    and ds where the kernels do, within 2e-2 of pure f32 on the same inputs,
    the lse within 1e-5."""
    from corrifnet_tpu_torch.ops import attention as t_attn

    b, h, n, _ = shape
    if packed:
        q, k, v = _randn((b, n, 3, h, 64), cuda).bfloat16().permute(2, 0, 3, 1, 4).unbind(0)
        g = _randn((b, n, h, 64), cuda).bfloat16().permute(0, 2, 1, 3)
    else:
        q, k, v, g = (_randn(shape, cuda).bfloat16() for _ in range(4))
    philox = (4321, 9)
    keep = None
    if rate > 0:
        keep = ops.philox_keep_mask(*philox, b * h, n, rate, "cuda").view(b, h, n, n)
    out, lse = t_attn._launch_fwd(q, k, v, 0.125, rate, *philox, True)
    rounded = ops.attention_plain(q, k, v, 0.125, rate, keep, kernel_rounding=True)
    exact = ops.attention_plain(q.float(), k.float(), v.float(), 0.125, rate, keep)
    assert _ulps_of_max(out, rounded) <= 2.0
    assert (out.float() - exact).abs().max().item() <= 2e-2
    scores = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * 0.125
    assert (lse - torch.logsumexp(scores, dim=-1)).abs().max().item() <= 1e-5
    del scores, rounded, exact
    grads = ops.fused_attention_bwd(q, k, v, out, lse, g, 0.125, rate, philox)
    rounded = ops.attention_backward_plain(q, k, v, out, lse, g, 0.125, rate, keep,
                                           kernel_rounding=True)
    for got, want in zip(grads, rounded):
        assert _ulps_of_max(got, want) <= 2.0
    del rounded
    exact = ops.attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                         g.float(), 0.125, rate, keep)
    for got, want in zip(grads, exact):
        assert (got.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.parametrize("b,n", [(2, 512), (4, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_on_strided_views_equals_contiguous(cuda, dtype, b, n):
    """Both kernels on the (B, H, N, 64) views of a (B, N, 3, H, 64) tensor
    with a (B, N, H, 64) cotangent against contiguous copies, and
    fused_attention_qkv against fused_attention under autograd with dropout:
    equal bits; the output and the gradient are laid out so that the
    surrounding reshapes are views."""
    from corrifnet_tpu_torch.ops import attention as t_attn

    h, philox = 8, (11, 12)
    qkv = _randn((b, n, 3, h, 64), cuda).to(dtype)
    g = _randn((b, n, h, 64), cuda).to(dtype).permute(0, 2, 1, 3)
    views = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    copies = [t.contiguous() for t in views]
    o1, l1 = t_attn._launch_fwd(*views, 0.125, 0.1, *philox, True)
    o2, l2 = t_attn._launch_fwd(*copies, 0.125, 0.1, *philox, True)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    g1 = ops.fused_attention_bwd(*views, o1, l1, g, 0.125, 0.1, philox)
    g2 = ops.fused_attention_bwd(*copies, o2.contiguous(), l2, g.contiguous(), 0.125, 0.1,
                                 philox)
    assert all(torch.equal(a, c) for a, c in zip(g1, g2))
    packed = qkv.clone().requires_grad_()
    f0, b0 = ops.fused_attention.launches, ops.fused_attention_bwd.launches
    out_p = ops.fused_attention_qkv(packed, 0.125, 0.1, philox)
    out_p.backward(g)
    assert ops.fused_attention.launches == f0 + 1
    assert ops.fused_attention_bwd.launches == b0 + 1
    assert torch.equal(out_p, o1) and packed.grad.is_contiguous()
    assert all(torch.equal(a, c)
               for a, c in zip(packed.grad.permute(2, 0, 3, 1, 4).unbind(0), g1))
    assert out_p.transpose(1, 2).reshape(b, n, h * 64).data_ptr() == out_p.data_ptr()


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


@pytest.mark.parametrize("layout", ["tile", "rows", "cols"])
def test_kernel_keep_mask_equals_philox_keep_mask(cuda, layout):
    """The mask each of the kernels' device functions writes (the f32
    kernels' byte tile, the bf16 forward's and dq pass's register bits, the
    bf16 dk/dv pass's 16-bit words), against the plain PyTorch Philox: exact;
    keep rate within 4 sigma of 0.9."""
    from corrifnet_tpu_torch.ops.attention import kernel_keep_mask

    n, rate = 512, 0.1
    got = kernel_keep_mask(99, 3, 5, 2, n, rate, layout=layout)
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
    from corrifnet_tpu_torch.ops import instancenorm as t_in

    for name in ("relu_instancenorm_plain", "relu_instancenorm_backward_plain",
                 "relu_instancenorm_stats_plain"):
        monkeypatch.setattr(t_in, name, boom)
    for dtype in (torch.float32, torch.bfloat16):
        z = _randn((2, 4, 4, 4, 24), cuda, shift=0.2).to(dtype).requires_grad_()
        ops.relu_instancenorm(z).backward(torch.ones_like(z))
        assert bool(torch.isfinite(z.grad).all())
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


@pytest.mark.parametrize("shape", _K3_SHAPES)
def test_relu_instancenorm_gradient(cuda, shape):
    """K3 and K3b under autograd, one launch each, against autograd through
    the plain version: f32 1e-5 + 1e-4 rel; bf16 within 2 bf16 ulps of the
    plain backward run in f32 on the same inputs, plus the f32 bound."""
    x = _randn(shape, cuda, shift=0.2)
    g = _randn(shape, cuda)
    before = ops.relu_instancenorm.launches, ops.relu_instancenorm_bwd.launches
    a = x.clone().requires_grad_()
    ops.relu_instancenorm(a).backward(g)
    torch.cuda.synchronize()
    assert (ops.relu_instancenorm.launches, ops.relu_instancenorm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    b = x.clone().requires_grad_()
    ops.relu_instancenorm_plain(b).backward(g)
    assert bool(((a.grad - b.grad).abs() <= 1e-5 + 1e-4 * b.grad.abs()).all())

    x16, g16 = x.bfloat16(), g.bfloat16()
    a16 = x16.clone().requires_grad_()
    ops.relu_instancenorm(a16).backward(g16)
    ref = ops.relu_instancenorm_backward_plain(x16.float(), g16.float())
    bound = 2 * _bf16_ulp(ref) + 1e-5 + 1e-4 * ref.abs()
    assert a16.grad.dtype == torch.bfloat16
    assert bool(((a16.grad.float() - ref).abs() <= bound).all())


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 192), (4, 64, 64, 64, 16)])
def test_relu_instancenorm_on_two_streams(cuda, shape):
    """16 calls of K3 and of K3b queued on each of two streams at once: every
    result the bits of a lone call (the grid barrier's two words are one
    pair a stream, 0 again after each launch)."""
    from corrifnet_tpu_torch.ops import instancenorm as t_in

    x = _randn(shape, cuda, shift=0.2).bfloat16()
    g = _randn(shape, cuda).bfloat16()
    y, mean, rstd = t_in._launch(x, 1e-5)
    dx = ops.relu_instancenorm_bwd(x, g, mean, rstd)
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(16):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append((t_in._launch(x, 1e-5)[0],
                             ops.relu_instancenorm_bwd(x, g, mean, rstd)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, y) and torch.equal(b, dx) for a, b in outs)


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
    # at B=2 the decoder is lean (batch rule): K3 ends the 15 RFM blocks only
    assert {n: w.launches for n, w in ops.KERNELS.items()} == {
        "correlation_fusion": 1, "correlation_fusion_bwd": 0,
        "fused_attention": 4, "fused_attention_bwd": 0, "relu_instancenorm": 15,
        "relu_instancenorm_bwd": 0,
        "pointwise_conv_stats": 108 * fused, "pointwise_conv_stats_bwd": 0,
        "conv3x3_fma_relu_stats": 39 * fused, "conv3x3_fma_relu_stats_bwd": 0}
    # a training forward and backward: every kernel's backward too
    model = create_model("MMVit4", dtype=torch.bfloat16, device="cuda",
                         pallas_fused_blocks=fused, transformer_dropout=0.0)
    model.train()
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    model(torch.randn(2, 3, 3, 64, 64, device="cuda")).float().mean().backward()
    torch.cuda.synchronize()
    assert {n: w.launches for n, w in ops.KERNELS.items()} == {
        "correlation_fusion": 1, "correlation_fusion_bwd": 1,
        "fused_attention": 4, "fused_attention_bwd": 4, "relu_instancenorm": 15,
        "relu_instancenorm_bwd": 15,
        "pointwise_conv_stats": 108 * fused, "pointwise_conv_stats_bwd": 108 * fused,
        "conv3x3_fma_relu_stats": 39 * fused, "conv3x3_fma_relu_stats_bwd": 39 * fused}


# ---------------------------------------------------------------- the decoder


def _on_both_devices(module, call, inputs, cotangent):
    """``call(module, *inputs)`` on the CPU and on the card (a copy of the
    module, same parameters): the output (a tensor or a tuple of tensors)
    and the gradients of sum(fma_or_output * cotangent) w.r.t. the inputs
    and the module's parameters, all as CPU tensors."""
    results = {}
    for dev in ("cpu", "cuda"):
        mod = copy.deepcopy(module).to(dev)
        leaves = [x.to(dev).requires_grad_() for x in inputs]
        out = call(mod, *leaves)
        head = out.y * out.a + out.b if isinstance(out, tuple) else out
        grads = torch.autograd.grad((head * cotangent.to(dev)).sum(),
                                    leaves + list(mod.parameters()))
        outs = list(out) if isinstance(out, tuple) else [out]
        results[dev] = ([t.detach().cpu() for t in outs], [g.cpu() for g in grads])
    return results["cpu"], results["cuda"]


@pytest.mark.parametrize("kind", ["linear", "nearest"])
def test_depth_fused_conv_on_the_card_equals_the_cpu(cuda, kind):
    """A depth-fused decoder conv at its real shape, f32: d1_c1 (16 channels
    at 64 rows of 128x128, up2 into 8 channels at 128 rows) and d1_c2 (the
    24-channel skip at its 3 rows and the 8-channel run at 128 rows). Every
    entry of the output and of the gradients of the input(s), the weight and
    the bias within 1e-5 of the sum of the magnitudes of the products it
    sums (the CPU's plain chain on |inputs|, |parameters|, |cotangent|): a
    weight gradient sums 2M products that cancel."""
    from corrifnet_tpu_torch.nn import Conv, resize_linear, resize_nearest

    gen = torch.Generator().manual_seed(5)
    conv = Conv(16 if kind == "linear" else 32, 8, 3, 1, 1, padding_mode="replicate")
    conv.reset_parameters(gen)
    if kind == "linear":
        xs = [torch.randn((1, 16, 64, 128, 128), generator=gen)]
    else:
        xs = [torch.randn((1, 24, 3, 128, 128), generator=gen),
              torch.randn((1, 8, 128, 128, 128), generator=gen)]
    g = torch.randn((1, 8, 128, 128, 128), generator=gen)
    (out, grads), (out_c, grads_c) = _on_both_devices(
        conv, lambda c, *x: c(x[0] if kind == "linear" else x, (kind, 128)), xs, g)

    def plain(c, *x):
        if kind == "linear":
            return c(resize_linear(x[0], (128,) * 3))
        return c(torch.cat([resize_nearest(x[0], (128,) * 3), x[1]], 1))

    magnitude = copy.deepcopy(conv)
    with torch.no_grad():
        for p in magnitude.parameters():
            p.abs_()
    leaves = [x.abs().requires_grad_() for x in xs]
    mag_out = plain(magnitude, *leaves)
    mags = [mag_out.detach()] + list(torch.autograd.grad(
        (mag_out * g.abs()).sum(), leaves + list(magnitude.parameters())))
    assert out_c[0].shape == (1, 8, 128, 128, 128)
    for got, want, mag in zip(out_c + grads_c, out + grads, mags):
        assert bool(((got - want).abs() <= 1e-5 * mag).all()), rel_max(got, want)


def test_lean_stage_on_the_card_equals_the_cpu(cuda):
    """A lean stage at its real shape, f32: d4_c2 (the 192-channel skip at its
    3 rows of 16x16 and the 128-channel handoff at 16 rows, into 64
    channels). The output handoff within 1e-5 of the CPU's largest entry; the
    gradients of the handoff, the skip, the weight and the bias under a
    random cotangent of the next fma within 1e-4 of the CPU's norm (a ReLU
    input within rounding of 0 may fall on the other side on the other
    device)."""
    from corrifnet_tpu_torch.nn.leandec import LeanGeneralConv3d, LeanHandoff

    gen = torch.Generator().manual_seed(6)
    stage = LeanGeneralConv3d(192 + 128, 64, 3, 1, 1, "replicate")
    stage.conv.reset_parameters(gen)
    inputs = [torch.relu(torch.randn((1, 128, 16, 16, 16), generator=gen)),
              torch.rand((1, 128, 1, 1, 1), generator=gen) + 0.5,
              torch.randn((1, 128, 1, 1, 1), generator=gen),
              torch.randn((1, 192, 3, 16, 16), generator=gen)]
    g = torch.randn((1, 64, 16, 16, 16), generator=gen)
    (out, grads), (out_c, grads_c) = _on_both_devices(
        stage, lambda st, y, a, b, skip: st((skip, LeanHandoff(y, a, b)), ("nearest", 16)),
        inputs, g)
    for got, want in zip(out_c, out):
        assert rel_max(got, want) <= 1e-5
    for got, want in zip(grads_c, grads):
        assert ((got - want).norm() / want.norm()).item() <= 1e-4


@pytest.mark.parametrize("lean,k3", [(None, 15), (False, 27)])
def test_b4_training_step_launches_k3_per_decoder_setting(cuda, lean, k3):
    """One bf16 training forward and backward at B=4, 224x224: K3 and K3b
    launch 15 times with the lean decoder (the batch rule at B=4), 27 with
    ``decoder_lean=False``."""
    from corrifnet_tpu_torch.models import create_model

    model = create_model("MMVit4", dtype=torch.bfloat16, device="cuda",
                         transformer_dropout=0.0, decoder_lean=lean)
    model.train()
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    x = torch.randn(4, 3, 3, 224, 224, device="cuda")
    model(x).float().mean().backward()
    torch.cuda.synchronize()
    assert ops.relu_instancenorm.launches == k3
    assert ops.relu_instancenorm_bwd.launches == k3


# ---------------------------------------------------------------- MMVit2, mmformer

# the K3 volumes of MMVit2's and mmformer's conv encoders at B=4 (cluster and
# grid regimes; the largest in two rounds at B=8) and their largest RFM volume
_K3_ENCODER_SHAPES = [(4, 3, 224, 224, 8), (4, 2, 112, 112, 16), (4, 1, 56, 56, 32),
                      (4, 1, 28, 28, 64), (4, 1, 14, 14, 64), (8, 3, 224, 224, 24)]


@pytest.mark.parametrize("shape", _K3_ENCODER_SHAPES)
def test_relu_instancenorm_at_the_conv_encoder_shapes(cuda, shape):
    """K3 and K3b at the conv-encoder family's volumes, under autograd, in
    bf16: one launch each, within 2 bf16 ulps of the plain versions run in
    f32 on the same inputs plus the f32 bound; in f32 within 1e-5 + 1e-4
    rel; a second run and runs queued on two streams give the same bits."""
    from corrifnet_tpu_torch.ops import instancenorm as t_in

    x = _randn(shape, cuda, shift=0.2)
    g = _randn(shape, cuda)
    a = x.clone().requires_grad_()
    y = ops.relu_instancenorm(a)
    y.backward(g)
    want = ops.relu_instancenorm_plain(x)
    assert bool(((y - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())
    ref = ops.relu_instancenorm_backward_plain(x, g)
    assert bool(((a.grad - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all())
    del want, ref
    x16, g16 = x.bfloat16(), g.bfloat16()
    before = ops.relu_instancenorm.launches, ops.relu_instancenorm_bwd.launches
    a16 = x16.clone().requires_grad_()
    y16 = ops.relu_instancenorm(a16)
    y16.backward(g16)
    torch.cuda.synchronize()
    assert (ops.relu_instancenorm.launches, ops.relu_instancenorm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for got, ref in ((y16, ops.relu_instancenorm_plain(x16.float())),
                     (a16.grad, ops.relu_instancenorm_backward_plain(x16.float(),
                                                                     g16.float()))):
        bound = 2 * _bf16_ulp(ref) + 1e-5 + 1e-4 * ref.abs()
        assert bool(((got.float() - ref).abs() <= bound).all())
    _, mean, rstd = t_in._launch(x16, 1e-5)
    lone = (y16.detach(), ops.relu_instancenorm_bwd(x16, g16, mean, rstd))
    assert torch.equal(lone[1], a16.grad)
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append((t_in._launch(x16, 1e-5)[0],
                             ops.relu_instancenorm_bwd(x16, g16, mean, rstd)))
    torch.cuda.synchronize()
    assert all(torch.equal(p, lone[0]) and torch.equal(q, lone[1]) for p, q in outs)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b", [4, 8])
def test_attention_at_n1536(cuda, b, rate):
    """K2f and K2b at the multimodal transformer of MMVit2 and mmformer
    (3 token groups, N = 1536), in bf16 on the strided views of a (B, N, 3,
    H, 64) projection as the model launches them: within 2 bf16 ulps of the
    largest entry of the plain versions that round where the kernels do and
    within 2e-2 of pure f32, in f32 within 2e-5; the keep mask of the
    kernels' device functions at n = 1536 equals ``philox_keep_mask``."""
    from corrifnet_tpu_torch.ops import attention as t_attn

    h, n = 8, 1536
    qkv = _randn((b, n, 3, h, 64), cuda)
    g = _randn((b, n, h, 64), cuda).permute(0, 2, 1, 3)
    philox = (20260, 17)
    keep = None
    if rate > 0:
        keep = ops.philox_keep_mask(*philox, b * h, n, rate, "cuda").view(b, h, n, n)
        for layout in ("tile", "rows", "cols"):
            assert torch.equal(t_attn.kernel_keep_mask(*philox, 0, 2, n, rate, layout=layout),
                               keep.view(b * h, n, n)[:2])
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    out = ops.fused_attention_qkv(qkv, 0.125, rate, philox)
    exact = ops.attention_plain(q, k, v, 0.125, rate, keep)
    assert (out - exact).abs().max().item() <= 2e-5
    q16, k16, v16 = qkv.bfloat16().permute(2, 0, 3, 1, 4).unbind(0)
    g16 = g.bfloat16()
    out16, lse = t_attn._launch_fwd(q16, k16, v16, 0.125, rate, *philox, True)
    rounded = ops.attention_plain(q16, k16, v16, 0.125, rate, keep, kernel_rounding=True)
    assert _ulps_of_max(out16, rounded) <= 2.0
    exact = ops.attention_plain(q16.float(), k16.float(), v16.float(), 0.125, rate, keep)
    assert (out16.float() - exact).abs().max().item() <= 2e-2
    del rounded, exact
    grads = ops.fused_attention_bwd(q16, k16, v16, out16, lse, g16, 0.125, rate, philox)
    rounded = ops.attention_backward_plain(q16, k16, v16, out16, lse, g16, 0.125, rate,
                                           keep, kernel_rounding=True)
    assert all(_ulps_of_max(a, r) <= 2.0 for a, r in zip(grads, rounded))


@pytest.mark.parametrize("name", ["MMVit2", "mmformer"])
def test_conv_family_on_the_card_matches_the_cpu(cuda, name):
    """The whole model at B=1 on a 64x64 input in f32: the kernels on the
    card against the plain versions on the CPU, same weights, within 1e-4
    or twice the CPU's own change under a 1e-6 change of the input (MMVit2's
    saturated correlation softmaxes amplify rounding); a bf16 forward at B=2
    and a training forward and backward launch the model's kernels: K1f 1
    (mmformer 0), K2f 4, K3 57 (the encoders' 42, the RFM blocks' 15; the
    lean decoder at B <= 4), and as many backwards."""
    from corrifnet_tpu_torch.models import create_model

    cpu = create_model(name, dtype=torch.float32, device="cpu", seed=0)
    x = torch.randn((1, 3, 3, 64, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = cpu(x)
        witness = (cpu(x * (1 + 1e-6)) - want).abs().max().item()
        got = copy.deepcopy(cpu).to("cuda")(x.to("cuda")).cpu()
    assert (got - want).abs().max().item() <= max(1e-4, 2 * witness)

    k1 = int(name == "MMVit2")
    model = create_model(name, dtype=torch.bfloat16, device="cuda", transformer_dropout=0.0)
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    with torch.no_grad():
        out = model(torch.zeros(2, 3, 3, 64, 64, device="cuda"))
    torch.cuda.synchronize()
    assert out.shape == (2, 3, 1, 224, 224) and bool(torch.isfinite(out).all())
    counts = dict.fromkeys(ops.KERNELS, 0)
    counts.update(correlation_fusion=k1, fused_attention=4, relu_instancenorm=57)
    assert {n: w.launches for n, w in ops.KERNELS.items()} == counts
    model.train()
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    model(torch.randn(2, 3, 3, 64, 64, device="cuda")).float().mean().backward()
    torch.cuda.synchronize()
    counts.update(correlation_fusion_bwd=k1, fused_attention_bwd=4, relu_instancenorm_bwd=57)
    assert {n: w.launches for n, w in ops.KERNELS.items()} == counts


@pytest.mark.parametrize("name", ["RFNet", "RobustMseg"])
def test_zoo_model_on_the_card_matches_the_cpu(cuda, name):
    """RFNet and RobustMseg at B=1 on a 64x64 input in f32 (RFNet's cascade
    runs at its fixed 16^3-128^3 volumes whatever the input), the card
    against the CPU, same weights: within 1e-4 or twice the CPU's own change
    under a 1e-6 change of the input; a bf16 forward and a training step at
    B=2 launch none of the port's kernels (the JAX package runs none on
    these models)."""
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.nn import DropoutRng

    cpu = create_model(name, dtype=torch.float32, device="cpu", seed=0)
    x = torch.randn((1, 3, 3, 64, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = cpu(x)
        witness = (cpu(x * (1 + 1e-6)) - want).abs().max().item()
        got = copy.deepcopy(cpu).to("cuda")(x.to("cuda")).cpu()
    assert (got - want).abs().max().item() <= max(1e-4, 2 * witness)

    model = create_model(name, dtype=torch.bfloat16, device="cuda")
    model.set_dropout_rng(DropoutRng(0, "cuda"))
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    with torch.no_grad():
        out = model(torch.zeros(2, 3, 3, 64, 64, device="cuda"))
    model.train()
    model(torch.randn(2, 3, 3, 64, 64, device="cuda")).float().mean().backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert all(w.launches == 0 for w in ops.KERNELS.values())


@pytest.mark.parametrize("name", ["MMVit4", "RFNet"])
def test_two_training_steps_repeat_their_bits(cuda, name):
    """Two B=4 bf16 training steps at 224x224 (dropout 0.1 where the model
    has it, Adam) from the same state, twice, under the entry points'
    ``deterministic()`` scope: every parameter, buffer and loss equal bit
    for bit (ROADMAP F5: before the scope and the port's own max-pool
    backward they were not)."""
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.nn import DropoutRng
    from corrifnet_tpu_torch.train import init_state, make_train_step
    from corrifnet_tpu_torch.utils.determinism import deterministic

    first = create_model(name, dtype=torch.bfloat16, device="cuda", seed=0)
    second = copy.deepcopy(first)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 4, 3, 3, 224, 224), generator=gen, device="cuda")
    masks = (torch.rand((2, 4, 3, 1, 224, 224), generator=gen, device="cuda") > 0.7).float()
    valid = torch.ones(4, device="cuda")
    losses = []
    with deterministic():
        for model in (first, second):
            model.set_dropout_rng(DropoutRng(0, "cuda"))
            step = make_train_step(init_state(model, "Adam"))
            losses.append(torch.stack([step(x[i], masks[i], valid, 1e-4) for i in range(2)]))
        torch.cuda.synchronize()
    assert torch.equal(losses[0], losses[1])
    b = second.state_dict()
    for key, value in first.state_dict().items():
        assert torch.equal(value, b[key]), key
