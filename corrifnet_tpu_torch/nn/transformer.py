"""Pre-norm transformer of the Intra/Inter/Multimodal formers.

Counterpart of ``corrifnet_tpu/nn/transformer.py`` (reference
mmvit4.py:295-388). Per depth step:

    x = x + pos
    x = x + Dropout(SelfAttention(LayerNorm(x)))
    x = x + FeedForward(LayerNorm(x))

``SelfAttention`` runs kernel K2. The reference's five dropout slots are
kept (``corrifnet_tpu/nn/transformer.py:57-71, 85-87, 116-118``): on the
attention probabilities (inside K2, from a Philox key), ``proj_drop``,
``attn_out_drop``, ``drop1`` and ``drop2``. They act in training mode at
rate ``dropout`` and are the identity in eval. Their randomness comes from
a ``DropoutRng`` set with ``Transformer.set_dropout_rng``, never from the
global generator. The ``nn.Identity`` placeholders inside ``FeedForward``
keep the reference's parameter names (``net.0``, ``net.3``).
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn.conv import Dense
from corrifnet_tpu_torch.nn.norm import LayerNorm
from corrifnet_tpu_torch.ops import fused_attention_qkv

__all__ = ["DropoutRng", "SelfAttention", "FeedForward", "Transformer"]


class DropoutRng:
    """The dropout randomness of one model, made from one seed: a host
    generator that gives the attention kernels their Philox keys (so a key
    never waits for the device, and a CPU run and a GPU run draw the same
    keys), and a generator on ``device`` for the masks made outside the
    kernels."""

    def __init__(self, seed: int, device="cpu"):
        self.keys = torch.Generator().manual_seed(seed)
        self.masks = torch.Generator(device=device).manual_seed(seed)

    def philox_key(self):
        """(seed, offset), two 31-bit integers drawn on the host."""
        return tuple(torch.randint(0, 2 ** 31 - 1, (2,), generator=self.keys).tolist())

    def keep(self, x, rate):
        """Bernoulli(1 - rate) keep mask of ``x``'s shape on ``x``'s device."""
        u = torch.rand(x.shape, generator=self.masks, device=x.device)
        return u >= rate


class _DropoutState:
    """What the dropout slots of one transformer share: the rate and the
    ``DropoutRng`` (None until ``Transformer.set_dropout_rng``)."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self.rng = None

    def active(self, training: bool):
        """(rate, rng) now: rate 0 in eval or when the rate is 0."""
        if not training or self.rate == 0.0:
            return 0.0, None
        if self.rng is None:
            raise RuntimeError(
                "training with dropout needs set_dropout_rng(DropoutRng(seed, device))"
            )
        return self.rate, self.rng


class _Dropout(nn.Module):
    """Inverted dropout (flax and PyTorch semantics: keep probability
    1 - rate, kept values scaled by 1/(1-rate))."""

    def __init__(self, state: _DropoutState):
        super().__init__()
        self.state = state

    def forward(self, x):
        rate, rng = self.state.active(self.training)
        if rate == 0.0:
            return x
        return torch.where(rng.keep(x, rate), x / (1.0 - rate), torch.zeros_like(x))


class SelfAttention(nn.Module):
    """qkv Linear without bias, head_dim**-0.5 scale, softmax with dropout
    on the probabilities, output projection with bias, ``proj_drop``
    (mmvit4.py:295-315). No layout copy surrounds the kernels: see
    ``ops.attention.fused_attention_qkv``."""

    def __init__(self, dim: int, heads: int = 8, state: _DropoutState = None):
        super().__init__()
        self.heads = heads
        self.state = state if state is not None else _DropoutState(0.0)
        self.qkv = Dense(dim, dim * 3, bias=False)
        self.proj = Dense(dim, dim)
        self.proj_drop = _Dropout(self.state)

    def forward(self, x):
        b, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h)
        rate, rng = self.state.active(self.training)
        philox = rng.philox_key() if rate > 0.0 else None
        # the kernels read q, k, v from the projection's output in place and
        # write (B, N, H, D) memory, so the reshape below is a view on the card
        out = fused_attention_qkv(qkv, (c // h) ** -0.5, rate, philox)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(b, n, c)))


class FeedForward(nn.Module):
    """Linear -> exact GELU -> drop1 -> Linear -> drop2."""

    def __init__(self, dim: int, hidden_dim: int, state: _DropoutState = None):
        super().__init__()
        state = state if state is not None else _DropoutState(0.0)
        self.net = nn.Sequential(
            Dense(dim, hidden_dim), nn.GELU(), nn.Identity(),
            Dense(hidden_dim, dim), nn.Identity(),
        )
        self.drop1 = _Dropout(state)
        self.drop2 = _Dropout(state)

    def forward(self, x):
        fc1, gelu, _, fc2, _ = self.net
        return self.drop2(fc2(self.drop1(gelu(fc1(x)))))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    """x + drop(fn(x)); ``drop`` is the ``attn_out_drop`` slot of the
    attention branch and absent on the feed-forward branch."""

    def __init__(self, fn: nn.Module, drop: nn.Module = None):
        super().__init__()
        self.fn = fn
        self.drop = drop

    def forward(self, x):
        y = self.fn(x)
        return x + (y if self.drop is None else self.drop(y))


class Transformer(nn.Module):
    """Pre-norm transformer with the positional embedding re-added at every
    depth step (mmvit4.py:360-388). ``dropout`` is the rate of its five
    dropout slots in training mode."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8,
                 mlp_dim: int = 512, dropout: float = 0.1):
        super().__init__()
        self.dropout_state = _DropoutState(dropout)
        state = self.dropout_state
        self.cross_attention_list = nn.ModuleList(
            Residual(PreNorm(dim, SelfAttention(dim, heads, state)), _Dropout(state))
            for _ in range(depth)
        )
        self.cross_ffn_list = nn.ModuleList(
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim, state)))
            for _ in range(depth)
        )

    def set_dropout_rng(self, rng: DropoutRng):
        self.dropout_state.rng = rng

    def forward(self, x, pos):
        for attn, ffn in zip(self.cross_attention_list, self.cross_ffn_list):
            x = ffn(attn(x + pos))
        return x
