"""The port's kernels against their plain versions on an NVIDIA GPU.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import). This file imports no
jax, so it runs on a machine without it, from the root of the checkout:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Bounds as in chip_smoke.py: f32 against the plain version in f32 (sums in
another order); bf16 against the plain version run in f32 on the same
bf16 inputs.
"""

from __future__ import annotations

import pytest
import torch

from corrifnet_tpu_torch import ops

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


def test_model_forward_runs_every_kernel(cuda):
    from corrifnet_tpu_torch.models import create_model

    model = create_model("MMVit4", dtype=torch.bfloat16, device="cuda")
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    with torch.no_grad():
        out = model(torch.zeros(2, 3, 3, 64, 64, device="cuda"))
    torch.cuda.synchronize()
    assert out.shape == (2, 3, 1, 224, 224) and bool(torch.isfinite(out).all())
    assert {n: w.launches for n, w in ops.KERNELS.items()} == {
        "correlation_fusion": 1, "fused_attention": 4, "relu_instancenorm": 27}
