"""MaxViT (torchvision ``maxvit_t``).

Port of ``curvature_tpu/models/maxvit.py`` (:41-237): a stem of two 3x3
convs (stride 2, BN eps 1e-3 and GELU, then stride 1 with bias), then per
layer an MBConv (BN pre-norm, 1x1 expand, depthwise 3x3, SiLU
squeeze-excitation, 1x1 project; an avg-pool + 1x1 shortcut where it
downsamples; the widths from the OUTPUT channels) and a window and a grid
attention, each a pre-norm relative-position MHA and a pre-norm MLP on
``[B, groups, P*P, C]`` tokens, and the classifier: spatial mean,
LayerNorm, Linear, tanh, bias-free Linear. Every conv and Dense is a
tracked layer; the bias tables are raw parameters and
``relative_position_index`` a buffer (``[P*P, P*P]``, JAX's ``"value"``
param). Module paths are torchvision's
(``blocks.0.layers.0.layers.window_attention.attn_layer.1.to_qkv``). The
convolutions run NCHW; the attention permutes to NHWC and partitions.

The attention logits are scaled by the full feature width ``c**-0.5``, not
the head width (torchvision's ``scale_factor``), and the softmax runs in
f32 and casts back. ``partition`` must divide every stage's map: 7 at
224² (``pipelines.common.build_model`` takes input/32).
"""
from typing import Optional

import torch
from torch import nn

from curvature_tpu_torch.models.blocks import (
    SqueezeExcitation, ZooNet, conv_bn, named)
from curvature_tpu_torch.models.swin import _relative_position_index
from curvature_tpu_torch.nn import (
    GELU, AvgPool, BatchNorm, Context, Conv, CtxModule, Dense, LayerNorm,
    Sequential, SiLU)
from curvature_tpu_torch.utils.device import resolve_device


def _partition(x, p):
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p, C] contiguous tiles."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p, c)


def _departition(x, p, gh, gw):
    """Inverse of :func:`_partition` back to [B, gh*p, gw*p, C]."""
    b, _, _, c = x.shape
    x = x.reshape(b, gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * p, gw * p, c)


class MBConv(CtxModule):
    """MaxViT's MBConv; ``proj`` is the shortcut's avg-pool and 1x1 conv
    (``proj.1``) where it downsamples, the 1x1 conv alone (``proj.0``)
    where only the width changes. The shortcut runs first, as in JAX (its
    conv is the first tracked layer of the block)."""

    def __init__(self, cin: int, cout: int, stride: int,
                 expansion: float = 4.0, squeeze: float = 0.25):
        super().__init__()
        mid = int(cout * expansion)
        sqz = int(cout * squeeze)
        self.proj = None
        if stride == 2:
            self.proj = Sequential([AvgPool(3, 2, 1), Conv(cin, cout, 1)])
        elif cin != cout:
            self.proj = Sequential([Conv(cin, cout, 1)])
        self.layers = named(
            pre_norm=BatchNorm(cin, eps=1e-3),
            conv_a=conv_bn(cin, mid, 1, act=GELU(), eps=1e-3),
            conv_b=conv_bn(mid, mid, 3, stride, groups=mid, act=GELU(),
                           eps=1e-3),
            squeeze_excitation=SqueezeExcitation(mid, sqz, act=SiLU()),
            conv_c=Conv(mid, cout, 1))

    def forward(self, x, ctx: Optional[Context] = None):
        res = x if self.proj is None else self.proj(x, ctx)
        return res + self.layers(x, ctx)


class RelativePositionalAttention(CtxModule):
    """torchvision's ``RelativePositionalMultiHeadAttention`` on
    ``[B, G, N, C]`` tokens: ``to_qkv``, the bias table, ``merge``."""

    def __init__(self, dim: int, head_dim: int, partition: int):
        super().__init__()
        self.heads = dim // head_dim
        self.head_dim = head_dim
        self.to_qkv = Dense(dim, 3 * dim)
        self.merge = Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            0.02 * torch.randn((2 * partition - 1) ** 2, self.heads))
        n = partition * partition
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index(partition).reshape(n, n)))

    def forward(self, x, ctx: Optional[Context] = None):
        b, g, n, c = x.shape
        heads, hd = self.heads, self.head_dim
        qkv = self.to_qkv(x, ctx)
        q, k, v = (z.reshape(b, g, n, heads, hd).permute(0, 1, 3, 2, 4)
                   for z in qkv.split(c, dim=-1))
        # scaled by the FULL feature width (torchvision's scale_factor)
        attn = (q @ k.transpose(-2, -1)) * (c ** -0.5)
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        bias = bias.reshape(n, n, heads).permute(2, 0, 1)
        attn = attn + bias[None, None].to(attn.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        y = (attn @ v).permute(0, 1, 3, 2, 4).reshape(b, g, n, c)
        return self.merge(y, ctx)


class PartitionAttention(CtxModule):
    """Window (``"window"``: P x P tiles) or grid (``"grid"``: tiles of
    H/P, the group and token axes swapped, so attention runs across
    strided positions) attention plus MLP, both pre-norm residual, on an
    NCHW map."""

    def __init__(self, dim: int, head_dim: int, partition: int, kind: str):
        super().__init__()
        self.partition = partition
        self.kind = kind
        self.attn_layer = Sequential([
            LayerNorm(dim),
            RelativePositionalAttention(dim, head_dim, partition)])
        self.mlp_layer = Sequential([LayerNorm(dim), Dense(dim, 4 * dim),
                                     GELU(), Dense(4 * dim, dim)])

    def forward(self, x, ctx: Optional[Context] = None):
        h, w = x.shape[2], x.shape[3]
        ps = self.partition
        if h % ps or w % ps:
            raise ValueError(
                f"feature map {h}x{w} is not divisible by the partition "
                f"size {ps} (torchvision asserts the same)")
        p = ps if self.kind == "window" else h // ps
        gh, gw = h // p, w // p
        x = _partition(x.permute(0, 2, 3, 1), p)
        if self.kind == "grid":
            x = x.transpose(-2, -3)
        x = x + self.attn_layer(x, ctx)
        x = x + self.mlp_layer(x, ctx)
        if self.kind == "grid":
            x = x.transpose(-2, -3)
        return _departition(x, p, gh, gw).permute(0, 3, 1, 2)


class MaxVitLayer(CtxModule):
    def __init__(self, cin: int, cout: int, stride: int, head_dim: int,
                 partition: int):
        super().__init__()
        self.layers = named(
            MBconv=MBConv(cin, cout, stride),
            window_attention=PartitionAttention(cout, head_dim, partition,
                                                "window"),
            grid_attention=PartitionAttention(cout, head_dim, partition,
                                              "grid"))

    def forward(self, x, ctx: Optional[Context] = None):
        return self.layers(x, ctx)


class MaxVitBlock(CtxModule):
    def __init__(self, cin: int, cout: int, depth: int, head_dim: int,
                 partition: int):
        super().__init__()
        self.layers = Sequential([
            MaxVitLayer(cin if j == 0 else cout, cout, 2 if j == 0 else 1,
                        head_dim, partition) for j in range(depth)])

    def forward(self, x, ctx: Optional[Context] = None):
        return self.layers(x, ctx)


class MaxVit(ZooNet):
    """NCHW images -> logits."""

    #: the ensemble evals run its members in a loop, not under
    #: ``torch.func.vmap`` (``eval/evaluate.py``): on the card its vmapped
    #: forward raises "NYI: querying is_contiguous inside of vmap for
    #: memory_format other than torch.contiguous_format" with contiguous
    #: members and input (torch 2.11, CUDA 12.8), where every other
    #: family of the zoo runs
    vmap_ensemble = False

    def __init__(self, stem_channels: int, block_channels, block_layers,
                 head_dim: int, partition: int, num_classes: int):
        super().__init__()
        self.stem = Sequential([
            conv_bn(3, stem_channels, 3, 2, act=GELU(), eps=1e-3),
            Sequential([Conv(stem_channels, stem_channels, 3, padding=1)])])
        blocks = []
        cin = stem_channels
        for cout, depth in zip(block_channels, block_layers):
            blocks.append(MaxVitBlock(cin, cout, depth, head_dim, partition))
            cin = cout
        self.blocks = Sequential(blocks)
        # torchvision's classifier: pool, flatten, LayerNorm (2), Linear
        # (3), Tanh, bias-free Linear (5)
        self.classifier = named(**{
            "2": LayerNorm(cin), "3": Dense(cin, cin),
            "5": Dense(cin, num_classes, bias=False)})
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.blocks(self.stem(x, ctx), ctx).mean(dim=(2, 3))
        cls = self.classifier
        x = torch.tanh(getattr(cls, "3")(getattr(cls, "2")(x), ctx))
        return getattr(cls, "5")(x, ctx)


def maxvit(stem_channels: int = 64, block_channels=(64, 128, 256, 512),
           block_layers=(2, 2, 5, 2), head_dim: int = 32,
           partition: int = 7, num_classes: int = 1000, device=None
           ) -> MaxVit:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return MaxVit(stem_channels, block_channels, block_layers, head_dim,
                  partition, num_classes).to(resolve_device(device))


def maxvit_t(num_classes: int = 1000, partition: int = 7, device=None
             ) -> MaxVit:
    """torchvision ``maxvit_t``: stem 64, channels (64, 128, 256, 512),
    depths (2, 2, 5, 2), head width 32, partition 7 (224² inputs; a
    smaller input needs a ``partition`` dividing every stage's map)."""
    return maxvit(num_classes=num_classes, partition=partition,
                  device=device)
