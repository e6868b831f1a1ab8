"""Segformer, a MiT hierarchical encoder and an all-MLP decoder (reference
segformer.py:171-216, a lucidrains-style implementation), for inference and
training, on the 4-D input path.

Counterpart of ``corrifnet_tpu/models/segformer.py``, NCHW, with the
reference ``state_dict`` layout that
``corrifnet_tpu.models.torch_import.segformer_variables_from_state_dict``
reads (``mit.stages.{si}.{1,2}``, ``to_fused.{si}.0``,
``to_segmentation.{0,1}``; ``nn.Identity`` placeholders keep the indices of
the reference's parameterless modules):

  * four stages with (kernel, stride, pad) = (7,4,3), (3,2,1), (3,2,1),
    (3,2,1): the reference's Unfold + 1x1 conv overlapping-patch embed, kept
    as its ``(O, I*k*k, 1, 1)`` weight and computed as the conv with the
    ``(O, I, k, k)`` view of it (Unfold orders a patch (c, kh, kw), the conv
    kernel's layout); then two layers of pre-norm efficient self-attention
    and mix feed-forward, each a residual;
  * ``ChannelNorm``: the reference's conv LayerNorm, per pixel over the
    channels, with the biased variance and eps *outside* the sqrt;
  * ``EfficientSelfAttention``: bias-free 1x1 q, a kernel-r stride-r kv conv
    (r = 8, 4, 2, 1), heads split head-major over the channels, the scores in
    the compute dtype, the softmax in f32, a bias-free 1x1 out;
  * ``MixFeedForward``: 1x1, depthwise 3x3, 1x1, exact GELU, 1x1;
  * decoder: per stage a 1x1 conv to 256 channels and a bilinear resize
    (``align_corners=False``) to ``out_size``, interpolated in f32; the four
    concatenated, two 1x1 convs, the sigmoid in f32.

No BatchNorm and no dropout: ``set_dropout_rng`` has nothing to give and
``transformer_dropout`` has no effect. ``debug_variant=True`` is the
orphan F32_SEGFORMER.py rebuild: nearest ``2**si`` fusion onto the stride-4
grid, the split ``to_segmentation1/2`` head, raw logits (no sigmoid), and
the three shape prints (NCHW, as the reference prints them). The JAX
package builds Segformer with ``dtype`` alone (neither entry point reaches
the debug variant) and runs none of its Pallas kernels on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.nn import Conv, resize_linear, resize_nearest

__all__ = ["ChannelNorm", "EfficientSelfAttention", "MixFeedForward", "OverlapPatchEmbed",
           "Segformer"]

STAGE_KSP = ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1))


def _conv(cin, cout, kernel=1, stride=1, padding=0, bias=True, groups=1):
    return Conv(cin, cout, kernel, stride, padding, bias=bias, dims=2,
                kernel_init="torch_default", groups=groups)


class ChannelNorm(nn.Module):
    """The reference's conv LayerNorm (segformer.py:30-40): per pixel over
    the channels, biased variance, eps outside the sqrt, in f32 and cast
    back; ``g`` and ``b`` are ``(1, C, 1, 1)``, as the reference keeps them."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.g.fill_(1.0)
            self.b.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf - mean).square().mean(dim=1, keepdim=True)
        return ((xf - mean) / (var.sqrt() + self.eps) * self.g + self.b).to(x.dtype)


class OverlapPatchEmbed(Conv):
    """The reference's ``nn.Unfold(k, s, p)`` + ``Conv2d(I*k*k, O, 1)``: the
    weight stays ``(O, I*k*k, 1, 1)``, and the conv runs with its
    ``(O, I, k, k)`` view, stride s and padding p."""

    def __init__(self, cin, cout, kernel, stride, padding):
        super().__init__(cin * kernel * kernel, cout, 1, dims=2, kernel_init="torch_default")
        self.patch = (cin, kernel, stride, padding)

    def kernel(self):
        cin, k, _, _ = self.patch
        return self.weight.view(self.weight.shape[0], cin, k, k)

    def forward(self, x):
        _, _, stride, padding = self.patch
        return F.conv2d(x, self.kernel().to(x.dtype), self._bias(x.dtype), stride, padding)


class EfficientSelfAttention(nn.Module):
    """Self-attention with the keys and values of a kernel-r stride-r conv
    (segformer.py:51-79); every projection bias-free."""

    def __init__(self, dim: int, heads: int, reduction_ratio: int):
        super().__init__()
        self.heads = heads
        self.to_q = _conv(dim, dim, bias=False)
        self.to_kv = _conv(dim, 2 * dim, reduction_ratio, reduction_ratio, bias=False)
        self.to_out = _conv(dim, dim, bias=False)

    def forward(self, x):
        b, c, h, w = x.shape
        hd = c // self.heads
        k, v = self.to_kv(x).chunk(2, dim=1)

        def to_heads(t):  # (B, C, H, W) -> (B, heads, N, hd), head-major channels
            return t.reshape(b, self.heads, hd, -1).transpose(2, 3)

        q = to_heads(self.to_q(x))
        sim = torch.matmul(q, to_heads(k).transpose(2, 3)) * hd ** -0.5
        attn = torch.softmax(sim.float(), dim=-1).to(q.dtype)
        out = torch.matmul(attn, to_heads(v)).transpose(2, 3).reshape(b, c, h, w)
        return self.to_out(out)


class _DsConv(nn.Module):
    """The reference's DsConv2d: ``net`` = (depthwise 3x3, 1x1)."""

    def __init__(self, dim):
        super().__init__()
        self.net = nn.Sequential(_conv(dim, dim, 3, padding=1, groups=dim), _conv(dim, dim))


class MixFeedForward(nn.Module):
    """1x1 -> depthwise 3x3 -> 1x1 -> exact GELU -> 1x1 (segformer.py:81-98),
    as the reference's ``net`` Sequential (its GELU at index 2)."""

    def __init__(self, dim: int, expansion_factor: int):
        super().__init__()
        hidden = dim * expansion_factor
        self.net = nn.Sequential(_conv(dim, hidden), _DsConv(hidden), nn.Identity(),
                                 _conv(hidden, dim))

    def forward(self, x):
        ds = self.net[1].net
        return self.net[3](F.gelu(ds[1](ds[0](self.net[0](x)))))


class _PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.fn = fn
        self.norm = ChannelNorm(dim)

    def forward(self, x):
        return self.fn(self.norm(x)) + x


class _MiT(nn.Module):
    """``stages.{si}`` = (Unfold placeholder, patch embed, layers), each
    layer (attention, feed-forward) under its pre-norm."""

    def __init__(self, dims, heads, ff_expansion, reduction_ratio, num_layers):
        super().__init__()
        cins = (3, *dims[:-1])
        self.stages = nn.ModuleList(
            nn.ModuleList([
                nn.Identity(),
                OverlapPatchEmbed(cin, dim, *ksp),
                nn.ModuleList(
                    nn.ModuleList([_PreNorm(dim, EfficientSelfAttention(dim, nh, rr)),
                                   _PreNorm(dim, MixFeedForward(dim, ffe))])
                    for _ in range(num_layers)),
            ])
            for cin, dim, ksp, nh, ffe, rr in zip(cins, dims, STAGE_KSP, heads, ff_expansion,
                                                  reduction_ratio))

    def forward(self, x):
        outputs = []
        for _, embed, layers in self.stages:
            x = embed(x)
            for attn, ff in layers:
                x = ff(attn(x))
            outputs.append(x)
        return outputs


class Segformer(nn.Module):
    """Input (B, 3, H, W) (one modality); output sigmoid probabilities
    (B, 1, *out_size) in f32, or with ``debug_variant`` raw f32 logits
    (B, 1, H/4, W/4). ``transformer_dropout`` has no effect: Segformer has no
    dropout."""

    def __init__(self, dtype: torch.dtype = torch.float32, transformer_dropout: float = 0.1,
                 dims=(32, 64, 160, 256), heads=(1, 2, 5, 8), ff_expansion=(8, 8, 4, 4),
                 reduction_ratio=(8, 4, 2, 1), num_layers=2, decoder_dim=256, num_classes=1,
                 out_size=(224, 224), debug_variant=False):
        super().__init__()
        del transformer_dropout  # no dropout in this architecture
        self.compute_dtype = dtype
        self.out_size = tuple(out_size)
        self.debug_variant = debug_variant
        self.mit = _MiT(dims, heads, ff_expansion, reduction_ratio, num_layers)
        self.to_fused = nn.ModuleList(nn.Sequential(_conv(d, decoder_dim), nn.Identity())
                                      for d in dims)
        seg = (_conv(len(dims) * decoder_dim, decoder_dim), _conv(decoder_dim, num_classes))
        if debug_variant:
            self.to_segmentation1, self.to_segmentation2 = seg
        else:
            self.to_segmentation = nn.Sequential(*seg)

    def reset_parameters(self, generator: torch.Generator):
        """Initialize every parameter from ``generator``, in module order:
        PyTorch's default conv initializer, ChannelNorm ones and zeros."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def set_dropout_rng(self, rng):
        """No dropout site: nothing to give."""
        return self

    def forward(self, x):
        fused = []
        for si, o in enumerate(self.mit(x.to(self.compute_dtype))):
            f = self.to_fused[si][0](o)
            if self.debug_variant:
                f = resize_nearest(f, (f.shape[2] * 2 ** si, f.shape[3] * 2 ** si))
            else:
                f = resize_linear(f, self.out_size, align_corners=False)
            fused.append(f)
        f = torch.cat(fused, dim=1)
        if not self.debug_variant:
            f = self.to_segmentation[1](self.to_segmentation[0](f))
            return torch.sigmoid(f.float())
        print(tuple(f.shape))  # F32:207
        f = self.to_segmentation1(f)
        print("Output Size after Conv1:", tuple(f.shape))  # F32:209
        f = self.to_segmentation2(f)
        print("Output Size after Conv2:", tuple(f.shape))  # F32:211
        return f.float()
