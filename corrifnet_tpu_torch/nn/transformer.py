"""Pre-norm transformer of the Intra/Inter/Multimodal formers.

Counterpart of ``corrifnet_tpu/nn/transformer.py`` (reference
mmvit4.py:295-388). Per depth step:

    x = x + pos
    x = x + SelfAttention(LayerNorm(x))
    x = x + FeedForward(LayerNorm(x))

Inference only: dropout is the identity in eval, so the reference's dropout
slots are ``nn.Identity`` here, kept so that parameter names (``net.0``,
``net.3``) stay the reference's. ``SelfAttention`` runs kernel K2.
"""

from __future__ import annotations

from torch import nn

from corrifnet_tpu_torch.nn.conv import Dense
from corrifnet_tpu_torch.nn.norm import LayerNorm
from corrifnet_tpu_torch.ops import fused_attention

__all__ = ["SelfAttention", "FeedForward", "Transformer"]


class SelfAttention(nn.Module):
    """qkv Linear without bias, head_dim**-0.5 scale, softmax, output
    projection with bias (mmvit4.py:295-315)."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, dim * 3, bias=False)
        self.proj = Dense(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)
        out = fused_attention(q, k, v, (c // h) ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class FeedForward(nn.Module):
    """Linear -> exact GELU -> Linear."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.net = nn.Sequential(
            Dense(dim, hidden_dim), nn.GELU(), nn.Identity(),
            Dense(hidden_dim, dim), nn.Identity(),
        )

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


class Transformer(nn.Module):
    """Pre-norm transformer with the positional embedding re-added at every
    depth step (mmvit4.py:360-388)."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8,
                 mlp_dim: int = 512):
        super().__init__()
        self.cross_attention_list = nn.ModuleList(
            Residual(PreNorm(dim, SelfAttention(dim, heads))) for _ in range(depth)
        )
        self.cross_ffn_list = nn.ModuleList(
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim))) for _ in range(depth)
        )

    def forward(self, x, pos):
        for attn, ffn in zip(self.cross_attention_list, self.cross_ffn_list):
            x = ffn(attn(x + pos))
        return x
