"""The port's training path against the JAX package, on the CPU in f32.

Inputs are made from a numpy seed and fed to both sides. The JAX side runs
as its own tests run it on the CPU: the ``_xla`` reference, or the Pallas
kernel in interpret mode (``INTERPRET = True``). On the CPU the port's
wrappers take their plain versions, whose formulas are what the GPU
kernels are held against on the card (chip_smoke.py, tests/test_torch_gpu.py).

Each test states its tolerance. The per-module bounds are tight (f32 sums
in another order). The whole-model train step is held to f32 bounds only
for the loss and the head (``test_train_step_matches_jax`` gives the
measured reason) and to tight bounds, tensor by tensor, in float64
(``test_train_step_matches_jax_in_f64``, in ``test_torch_train_f64.py``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrifnet_tpu.ops.attention as jax_attn
import corrifnet_tpu.ops.correlation as jax_corr
import corrifnet_tpu.ops.instancenorm as jax_in
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch import nn as tnn
from corrifnet_tpu_torch import ops
from corrifnet_tpu_torch.models import jax_import
from corrifnet_tpu_torch.ops import attention as t_attn
from torch_train_step import check_train_step, jax_step  # noqa: F401 (fixture)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# the default decoder on both sides: depth-fused, lean at B=1
DECODER_LEAN = None

CORR_ATOL = 1e-6   # K1: elementwise, f32
ATTN_ATOL = 2e-5   # K2: N-long sums of products, f32
IN_ATOL = 1e-5     # K3: statistics over the volume, f32


def _normal(shape, seed, scale=1.0, shift=0.0):
    return np.random.default_rng(seed).normal(shift, scale, shape).astype(np.float32)


class _interpret:
    """Run a JAX ops module's Pallas kernels in interpret mode (CPU)."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        self.mod.INTERPRET = True

    def __exit__(self, *exc):
        self.mod.INTERPRET = False


def _torch_grads(fn, arrays, cotangent):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cotangent))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(fn, arrays, cotangent):
    def scalar(*xs):
        return (fn(*xs) * cotangent).sum()

    out = fn(*map(jnp.asarray, arrays))
    grads = jax.grad(scalar, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(g) for g in grads]


# ---------------------------------------------------------------- K1 backward


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_correlation_backward_matches_jax(reference):
    """K1b's formulas and autograd through the plain forward, against
    jax.grad of correlation_fusion_xla and the Pallas _bwd_kernel: 1e-6."""
    arrays = [_normal((3, 2, 16, 128), 40 + i) for i in range(3)]
    g = _normal((3, 2, 16, 128), 43)
    if reference == "xla":
        _, want = _jax_grads(jax_corr.correlation_fusion_xla, arrays, g)
    else:
        with _interpret(jax_corr):
            _, want = _jax_grads(
                lambda q, k, v: jax_corr.correlation_fusion(
                    q, k, v, use_pallas=True, block_rows=8), arrays, g)
    _, auto = _torch_grads(ops.correlation_fusion, arrays, g)
    formulas = ops.correlation_fusion_bwd(*map(torch.from_numpy, arrays),
                                          torch.from_numpy(g))
    for a, f, w in zip(auto, formulas, want):
        np.testing.assert_allclose(a, w, atol=CORR_ATOL, rtol=0)
        np.testing.assert_allclose(f.numpy(), w, atol=CORR_ATOL, rtol=0)


# ---------------------------------------------------------------- K2


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("n", [128, 512])
def test_attention_forward_and_gradients_match_jax(n, reference):
    """Rate 0: output and dq, dk, dv against attention_xla and against the
    Pallas forward and backward kernels in interpret mode: 2e-5."""
    arrays = [_normal((1, 2, n, 64), 50 + i) for i in range(3)]
    g = _normal((1, 2, n, 64), 53)
    if reference == "xla":
        want, want_g = _jax_grads(
            lambda q, k, v: jax_attn.attention_xla(q, k, v, 0.125), arrays, g)
    else:
        with _interpret(jax_attn):
            want, want_g = _jax_grads(
                lambda q, k, v: jax_attn.fused_attention(q, k, v, 0.125), arrays, g)
    got, got_g = _torch_grads(lambda q, k, v: ops.fused_attention(q, k, v, 0.125),
                              arrays, g)
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=0)
    for a, w in zip(got_g, want_g):
        np.testing.assert_allclose(a, w, atol=ATTN_ATOL, rtol=0)
    # the backward entry point on CPU tensors gives the same gradients
    q, k, v = map(torch.from_numpy, arrays)
    again = ops.fused_attention_bwd(q, k, v, torch.from_numpy(got), None,
                                    torch.from_numpy(g), 0.125)
    for a, b in zip(again, got_g):
        np.testing.assert_array_equal(a.numpy(), b)


def test_attention_with_dropout_matches_the_jax_composition():
    """Rate 0.1 with a given keep mask: output and gradients against the
    same composition in jnp (drop after the softmax, scale by 1/(1-rate)): 2e-5."""
    rate, n = 0.1, 128
    arrays = [_normal((2, 2, n, 64), 60 + i) for i in range(3)]
    g = _normal((2, 2, n, 64), 63)
    keep = t_attn.philox_keep_mask(11, 12, 4, n, rate).view(2, 2, n, n)

    def jax_fn(q, k, v):
        s = jnp.einsum("bhnd,bhmd->bhnm", q, k) * 0.125
        p = jax.nn.softmax(s, axis=-1)
        p = jnp.where(jnp.asarray(keep.numpy()), p / (1.0 - rate), 0.0)
        return jnp.einsum("bhnm,bhmd->bhnd", p, v)

    want, want_g = _jax_grads(jax_fn, arrays, g)
    got, got_g = _torch_grads(
        lambda q, k, v: ops.attention_plain(q, k, v, 0.125, rate, keep), arrays, g)
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=0)
    for a, w in zip(got_g, want_g):
        np.testing.assert_allclose(a, w, atol=ATTN_ATOL, rtol=0)
    # the wrapper on CPU tensors makes that very mask from the Philox key
    via_key, _ = _torch_grads(
        lambda q, k, v: ops.fused_attention(q, k, v, 0.125, rate, (11, 12)), arrays, g)
    np.testing.assert_array_equal(via_key, got)


# ---------------------------------------------------------------- Philox


def _np_philox4x32_10(counter, key):
    """Philox4x32-10 in numpy uint64 arithmetic, written independently of
    the port's: counter (4,) + shape uint32 words, key two words."""
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    mask = np.uint64(0xFFFFFFFF)
    c = [np.asarray(w, dtype=np.uint64) for w in counter]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for _ in range(10):
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & mask]
        k0 = (k0 + np.uint64(0x9E3779B9)) & mask
        k1 = (k1 + np.uint64(0xBB67AE85)) & mask
    return c


def test_philox_known_answers():
    """Random123's known answers for Philox4x32-10."""
    zero = torch.zeros(1, dtype=torch.int64)
    got = [int(w) for w in t_attn.philox4x32_10((zero,) * 4, (0, 0))]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    ones = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    got = [int(w) for w in t_attn.philox4x32_10((ones,) * 4, (0xFFFFFFFF, 0xFFFFFFFF))]
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert [int(w) for w in _np_philox4x32_10([0, 0, 0, 0], (0, 0))] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_keep_mask_against_numpy():
    """The mask equals an independent numpy Philox with counter (column/4,
    row, batch*head, 0), key (seed, offset), keep = word >= rate * 2^32."""
    seed, offset, bh, n, rate, bh0 = 123456789, 4242, 3, 64, 0.1, 7
    got = t_attn.philox_keep_mask(seed, offset, bh, n, rate, bh0=bh0).numpy()
    groups, rows, heads = np.meshgrid(np.arange(n // 4), np.arange(n),
                                      np.arange(bh0, bh0 + bh), indexing="ij")
    words = _np_philox4x32_10([groups, rows, heads, np.zeros_like(groups)],
                              (seed, offset))
    keep = np.stack(words, axis=-1) >= np.uint64(int(rate * 2 ** 32))
    want = keep.transpose(2, 1, 0, 3).reshape(bh, n, n)  # (bh, row, 4*group + word)
    np.testing.assert_array_equal(got, want)


def test_philox_keep_mask_statistics():
    rate = 0.1
    a = t_attn.philox_keep_mask(1, 2, 8, 256, rate)
    sigma = math.sqrt(rate * (1 - rate) / a.numel())
    assert abs(a.float().mean().item() - (1 - rate)) <= 4 * sigma  # 4 sigma
    assert torch.equal(a, t_attn.philox_keep_mask(1, 2, 8, 256, rate))
    assert not torch.equal(a, t_attn.philox_keep_mask(1, 3, 8, 256, rate))
    assert not torch.equal(a, t_attn.philox_keep_mask(2, 2, 8, 256, rate))
    assert not torch.equal(a[0], a[1])  # different rows for different bh
    assert torch.equal(a[3:5], t_attn.philox_keep_mask(1, 2, 2, 256, rate, bh0=3))
    assert bool(t_attn.philox_keep_mask(1, 2, 1, 64, 0.0).all())


# ---------------------------------------------------------------- K3 gradient


@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 8), (2, 4, 6, 6, 20), (1, 2, 4, 4, 192)])
def test_relu_instancenorm_gradient_matches_jax(shape):
    """Autograd through the plain forward and the backward formula that the
    autograd.Function uses on the card, against jax.grad of
    relu_instancenorm (whose VJP differentiates relu_instancenorm_xla): 1e-5."""
    x, g = _normal(shape, 70, shift=0.3), _normal(shape, 71)
    _, (want,) = _jax_grads(jax_in.relu_instancenorm, [x], g)
    _, (auto,) = _torch_grads(ops.relu_instancenorm, [x], g)
    formula = ops.relu_instancenorm_backward_plain(torch.from_numpy(x),
                                                   torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(auto, want, atol=IN_ATOL, rtol=0)
    np.testing.assert_allclose(formula, want, atol=IN_ATOL, rtol=0)


def test_autograd_functions_run_their_backward_formulas():
    """The three autograd.Functions, driven on the CPU with their kernel
    launches replaced by the plain forwards: the backward each one defines
    (the entry points of K1b, K2b and K3b, this one on the statistics the
    forward saved) gives autograd's gradients."""
    from corrifnet_tpu_torch.ops import correlation as t_corr
    from corrifnet_tpu_torch.ops import instancenorm as t_in

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_corr, "_launch_fwd", t_corr.correlation_fusion_plain)
        mp.setattr(t_in, "_launch", lambda x, eps: (t_in.relu_instancenorm_plain(x, eps),
                                                     *t_in.relu_instancenorm_stats_plain(x, eps)))
        mp.setattr(t_attn, "_launch_fwd",
                   lambda q, k, v, scale, rate, seed, offset, with_lse:
                   (ops.fused_attention(q, k, v, scale, rate, (seed, offset)), None))
        mp.setattr(t_attn._FusedAttention, "backward", staticmethod(
            lambda ctx, d: (*ops.fused_attention_bwd(
                *ctx.saved_tensors, d, *ctx.args), None, None, None, None)))
        cases = [
            (t_corr._CorrelationFusion.apply, ops.correlation_fusion_plain,
             [_normal((3, 1, 4, 8), 80 + i) for i in range(3)], ()),
            (t_in._ReluInstanceNorm.apply, ops.relu_instancenorm_plain,
             [_normal((2, 3, 3, 3, 8), 83, shift=0.2)], (1e-5,)),
            (t_attn._FusedAttention.apply,
             lambda q, k, v, *a: ops.fused_attention(q, k, v, 0.125, 0.1, (3, 4)),
             [_normal((1, 1, 64, 64), 84 + i) for i in range(3)], (0.125, 0.1, 3, 4)),
        ]
        for function, plain, arrays, extra in cases:
            g = _normal(arrays[0].shape, 89)
            _, got = _torch_grads(lambda *xs: function(*xs, *extra), arrays, g)
            _, want = _torch_grads(lambda *xs: plain(*xs, *extra), arrays, g)
            for a, w in zip(got, want):
                np.testing.assert_allclose(a, w, atol=2e-6, rtol=0)
    finally:
        mp.undo()


# ---------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("shape", [(2, 6, 3, 5, 5), (1, 4, 3, 2, 2)])
def test_batchnorm_train_matches_jax(shape):
    """Train mode: the output (batch mean, biased variance) and both running
    buffers (momentum 0.1, unbiased variance) against
    corrifnet_tpu.nn.norm.BatchNorm(use_running_average=False): 1e-6."""
    from corrifnet_tpu.nn import BatchNorm as JBN

    rng = np.random.default_rng(90)
    c = shape[1]
    bn = tnn.BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    sd = {f"b.{k}": v.clone() for k, v in bn.state_dict().items()}
    p, s = ti._bn(sd, "b")
    x = _normal(shape, 91, scale=2.0, shift=0.5)
    xt = torch.from_numpy(x).requires_grad_()
    got = bn(xt)
    want, mut = JBN().apply({"params": p, "batch_stats": s},
                            jnp.asarray(np.moveaxis(x, 1, -1)),
                            use_running_average=False, mutable=["batch_stats"])
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1),
                               np.asarray(want), atol=2e-6, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=1e-6, rtol=1e-6)
    # gradients flow through the batch statistics, as in JAX
    g = _normal(shape, 92)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))

    def jax_out(xx):
        y, _ = JBN().apply({"params": p, "batch_stats": s}, xx,
                           use_running_average=False, mutable=["batch_stats"])
        return (y * np.moveaxis(g, 1, -1)).sum()

    want_dx = np.asarray(jax.grad(jax_out)(jnp.asarray(np.moveaxis(x, 1, -1))))
    np.testing.assert_allclose(np.moveaxis(dx.numpy(), 1, -1), want_dx, atol=1e-5, rtol=0)
    # eval mode reads the updated buffers and changes nothing
    before = bn.running_mean.clone()
    bn.eval()(torch.from_numpy(x))
    assert torch.equal(bn.running_mean, before)


# ---------------------------------------------------------------- transformer


def _init(module, seed):
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return module


def test_transformer_train_mode_gradients_match_jax():
    """Training mode at dropout 0: output and every parameter gradient
    against the JAX Transformer with deterministic=False, dropout_rate=0: 2e-5."""
    from corrifnet_tpu.nn import Transformer as JT

    tr = _init(tnn.Transformer(512, 1, 8, 512, dropout=0.0), 100).train()
    x, pos = _normal((2, 64, 512), 101), _normal((1, 64, 512), 102, scale=0.1)
    g = _normal((2, 64, 512), 103)
    sd = {f"t.{k}": v for k, v in tr.state_dict().items()}
    params = ti._transformer(sd, "t")
    jm = JT(512, depth=1, heads=8, mlp_dim=512, dropout_rate=0.0)

    def scalar(p, xx):
        out = jm.apply({"params": p}, xx, jnp.asarray(pos), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * g).sum(), out

    (_, want), (gp, gx) = jax.value_and_grad(scalar, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tr(xt, torch.from_numpy(pos))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-5, rtol=0)
    named = {}
    jax_import._transformer(named, "t", jax.tree.map(np.asarray, gp))
    for name, p in tr.named_parameters():
        want_g = named[f"t.{name}"].numpy()
        bound = 2e-5 * max(1.0, np.abs(want_g).max())
        np.testing.assert_allclose(p.grad.numpy(), want_g, atol=bound, rtol=0, err_msg=name)


def test_transformer_dropout_slots():
    """Rate 0.1: identity in eval; in training the elementwise slots keep
    1 - p of the entries (4 sigma) and scale the kept ones by 1/(1-p); the
    stream is a function of the DropoutRng's seed; training without one
    raises. Bitstreams carry no parity requirement."""
    from corrifnet_tpu_torch.nn.transformer import _Dropout, _DropoutState

    rate = 0.1
    state = _DropoutState(rate)
    drop = _Dropout(state)
    x = torch.from_numpy(_normal((64, 512), 110, shift=3.0))
    assert drop.eval()(x) is x
    drop.train()
    with pytest.raises(RuntimeError, match="set_dropout_rng"):
        drop(x)
    state.rng = tnn.DropoutRng(5)
    y = drop(x)
    kept = y != 0
    sigma = math.sqrt(rate * (1 - rate) / x.numel())
    assert abs(kept.float().mean().item() - (1 - rate)) <= 4 * sigma
    np.testing.assert_allclose(y[kept].numpy(), (x[kept] / (1 - rate)).numpy(), rtol=1e-6)

    tr = _init(tnn.Transformer(512, 1, 8, 512, dropout=rate), 111)
    xs = torch.from_numpy(_normal((1, 64, 512), 112))
    pos = torch.zeros(1, 64, 512)
    with torch.no_grad():
        ref = tr.eval()(xs, pos)
        tr.train()
        tr.set_dropout_rng(tnn.DropoutRng(7))
        a = tr(xs, pos)
        tr.set_dropout_rng(tnn.DropoutRng(7))
        b = tr(xs, pos)
        tr.set_dropout_rng(tnn.DropoutRng(8))
        c = tr(xs, pos)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ref)
    assert bool(torch.isfinite(a).all())
    keys = tnn.DropoutRng(3)
    assert keys.philox_key() != keys.philox_key()
    assert tnn.DropoutRng(3).philox_key() == tnn.DropoutRng(3).philox_key()


# ---------------------------------------------------------------- losses, schedule


def test_bce_with_logits_matches_jax_and_torch():
    from corrifnet_tpu.metrics import bce_with_logits as jb
    from corrifnet_tpu_torch.metrics import bce_with_logits, reference_bce_loss

    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, size=(64, 7)).astype(np.float32)
    y = rng.random((64, 7)).astype(np.float32)
    got = bce_with_logits(torch.from_numpy(x), torch.from_numpy(y)).item()
    np.testing.assert_allclose(got, float(jb(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)
    want = torch.nn.BCEWithLogitsLoss()(torch.from_numpy(x), torch.from_numpy(y)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    probs = torch.sigmoid(torch.from_numpy(x))  # the double sigmoid
    np.testing.assert_allclose(
        reference_bce_loss(probs, torch.from_numpy(y)).item(),
        torch.nn.BCEWithLogitsLoss()(probs, torch.from_numpy(y)).item(), rtol=1e-6)


@pytest.mark.parametrize("empty", [False, True])
def test_jaccard2_masked_matches_jax(empty):
    """With padded rows, against the JAX function and the numpy oracle of
    F5_JACCARD2.py restricted to the valid rows: 1e-6 relative."""
    from corrifnet_tpu.metrics import jaccard2_masked as jm
    from corrifnet_tpu_torch.metrics import jaccard2, jaccard2_masked

    rng = np.random.default_rng(4)
    y = np.zeros((100, 1), np.float32) if empty else (
        rng.random((100, 1)) > 0.6).astype(np.float32)
    y_pred = rng.random((100, 1)).astype(np.float32)
    y_p = np.concatenate([y, np.zeros((40, 1), np.float32)])
    yp_p = np.concatenate([y_pred, np.full((40, 1), 0.9, np.float32)])
    valid = np.concatenate([np.ones((100, 1)), np.zeros((40, 1))]).astype(np.float32)
    got = jaccard2_masked(*map(torch.from_numpy, (y_p, yp_p, valid))).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(y_p, yp_p, valid)), rtol=1e-6)
    want = jaccard2(torch.from_numpy(y), torch.from_numpy(y_pred)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_masked_loss_and_jaccard_on_a_padded_batch():
    """valid = 1, 1, 1, 0: loss, Jaccard and n_valid against the JAX
    function (1e-6), and equal to the unpadded three samples."""
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard as jml
    from corrifnet_tpu_torch.train import masked_loss_and_jaccard

    rng = np.random.default_rng(120)
    out = rng.random((4, 3, 1, 16, 16)).astype(np.float32)
    masks = (rng.random((4, 3, 1, 16, 16)) > 0.6).astype(np.float32)
    out[3], masks[3] = 0.7, 0.0
    valid = np.array([1, 1, 1, 0], np.float32)
    got = masked_loss_and_jaccard(*map(torch.from_numpy, (out, masks, valid)))
    want = jml(jnp.asarray(out), jnp.asarray(masks), jnp.asarray(valid))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.item(), float(w), rtol=1e-6)
    solo = masked_loss_and_jaccard(torch.from_numpy(out[:3]), torch.from_numpy(masks[:3]),
                                   torch.ones(3))
    np.testing.assert_allclose(got[0].item(), solo[0].item(), rtol=1e-6)
    np.testing.assert_allclose(got[1].item(), solo[1].item(), rtol=1e-6)
    assert got[2].item() == 3.0


def test_step_lr_matches_jax_over_12_epochs():
    from corrifnet_tpu.train.schedule import step_lr as js, step_lr_reported as jr
    from corrifnet_tpu_torch.train import step_lr, step_lr_reported

    for epoch in range(12):
        assert step_lr(1e-4, 5, 0.9, epoch) == js(1e-4, 5, 0.9, epoch)
        assert step_lr_reported(1e-4, 5, 0.9, epoch) == jr(1e-4, 5, 0.9, epoch)
    assert abs(step_lr(1e-4, 5, 0.9, 4) - 9e-5) < 1e-12
    assert abs(step_lr_reported(1e-4, 5, 0.9, 4) - 8.1e-5) < 1e-12


def test_make_optimizer_kinds():
    from corrifnet_tpu_torch.train import make_optimizer

    w = torch.nn.Parameter(torch.ones(3))
    adam = make_optimizer("Adam", [w])
    assert adam.defaults["betas"] == (0.9, 0.999) and adam.defaults["eps"] == 1e-8
    assert isinstance(make_optimizer("SGD", [w]), torch.optim.SGD)
    with pytest.raises(ValueError, match="optimizerType"):
        make_optimizer("RMSprop", [w])


# ---------------------------------------------------------------- whole train step


@pytest.mark.parametrize("batch,padded", [(1, False)])
def test_train_step_matches_jax(jax_step, batch, padded):
    """One whole MMVit4 train step and a second after Adam against JAX
    (bounds and their reasons: ``torch_train_step.check_train_step``); the
    B=4 case with a padded sample is in ``test_torch_train_b4.py``."""
    check_train_step(jax_step, batch, padded, DECODER_LEAN)
