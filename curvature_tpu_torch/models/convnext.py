"""ConvNeXt (tiny, small, base, large) with torchvision names.

Port of ``curvature_tpu/models/convnext.py``. Each block is a depthwise
7x7 conv (groups = channels: one 49(+1)-column Kronecker basis per
channel), LayerNorm, Linear(4C), GELU, Linear(C) on the channels-last
feature map (tracked layers whose inputs are [B, H, W, C] tokens, as a
transformer MLP's), scaled by the untracked ``layer_scale`` parameter
(``[C, 1, 1]``, the JAX ``{name}.layer_scale`` group's ``"value"``), plus
the residual. The stem is a 4x4 stride-4 patchify conv and a channel
LayerNorm; the stages are joined by a channel LayerNorm and a 2x2
stride-2 conv. The stem and downsampling convs carry the string padding
'VALID', as in JAX, which keeps them off the kernel route. Layer names are
torchvision's (``features.1.0.block.0``, ``features.2.1``,
``classifier.2``).
"""
from typing import Optional

import torch
from torch import nn

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    GELU, ChannelLayerNorm, Context, Conv, CtxModule, Dense, Flatten,
    GlobalAvgPool, LayerNorm, Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device


class Permute(nn.Module):
    def __init__(self, *dims):
        super().__init__()
        self.dims = dims

    def forward(self, x):
        return x.permute(*self.dims)


class CNBlock(CtxModule):
    """torchvision's ``CNBlock``: ``block`` = dw 7x7 [0], Permute [1],
    LayerNorm [2], Linear [3], GELU [4], Linear [5], Permute [6];
    stochastic depth is an eval no-op."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = Sequential([
            Conv(dim, dim, 7, padding=3, groups=dim), Permute(0, 2, 3, 1),
            LayerNorm(dim, eps=1e-6), Dense(dim, 4 * dim), GELU(),
            Dense(4 * dim, dim), Permute(0, 3, 1, 2)])
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), 1e-6))

    def forward(self, x, ctx: Optional[Context] = None):
        return x + self.layer_scale * self.block(x, ctx)


#: arch -> (per-stage block counts, per-stage dims): torchvision's
_CONFIGS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}


class ConvNeXt(ZooNet):
    def __init__(self, depths, dims, num_classes: int):
        super().__init__()
        features = [Sequential([Conv(3, dims[0], 4, 4),
                                ChannelLayerNorm(dims[0], eps=1e-6)])]
        for s, (n, dim) in enumerate(zip(depths, dims)):
            features.append(Sequential([CNBlock(dim) for _ in range(n)]))
            if s + 1 < len(dims):
                features.append(Sequential([
                    ChannelLayerNorm(dim, eps=1e-6),
                    Conv(dim, dims[s + 1], 2, 2)]))
        self.features = Sequential(features)
        self.pool = GlobalAvgPool()
        self.classifier = Sequential([LayerNorm(dims[-1], eps=1e-6),
                                      Flatten(), Dense(dims[-1],
                                                       num_classes)])
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        return self.classifier(self.pool(self.features(x, ctx)), ctx)


def convnext(arch: str, num_classes: int = 1000, device=None) -> ConvNeXt:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    depths, dims = _CONFIGS[arch]
    return ConvNeXt(depths, dims, num_classes).to(resolve_device(device))


def convnext_tiny(num_classes: int = 1000, device=None) -> ConvNeXt:
    return convnext("convnext_tiny", num_classes, device)
