"""VGG-11/13/16/19, with and without BatchNorm, with torchvision names.

Port of ``curvature_tpu/models/vgg.py``: 3x3 convs with bias at
``features.{i}`` (the BN at ``features.{i+1}``), 2x2 max pools, the
7x7 adaptive pool, and the classifier's three dense layers at
``classifier.0``/``.3``/``.6`` (the dropouts between them are eval
no-ops). ``classifier.0`` has fan-in 25,088: its A factor, 25,089 wide,
is past KFAC's default ``max_factor_dim``, which raises there as in JAX.
"""
from typing import Optional

import torch

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    BatchNorm, Context, Conv, Dense, Flatten, Identity, MaxPool, ReLU,
    Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device

_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class AdaptiveAvgPool7(torch.nn.Module):
    """torchvision's ``AdaptiveAvgPool2d((7, 7))`` as the JAX package
    computes it (vgg.py:27-45): identity at 7x7, the bin mean where 7
    divides both extents, else each row and column repeated ceil(7/n)
    times and the top-left 7x7 kept. Below 7 (and at 8-13) that is not
    ``F.adaptive_avg_pool2d``, which averages overlapping bins."""

    def forward(self, x):
        b, c, h, w = x.shape
        if (h, w) == (7, 7):
            return x
        if h >= 7 and h % 7 == 0 and w % 7 == 0:
            return x.reshape(b, c, 7, h // 7, 7, w // 7).mean(dim=(3, 5))
        up = x.repeat_interleave(-(-7 // h), dim=2) \
            .repeat_interleave(-(-7 // w), dim=3)
        return up[:, :, :7, :7]


class VGG(ZooNet):
    def __init__(self, cfg, num_classes: int, batch_norm: bool = False):
        super().__init__()
        layers, cin = [], 3
        for v in cfg:
            if v == "M":
                layers.append(MaxPool(2, 2))
                continue
            layers.append(Conv(cin, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm(v))
            layers.append(ReLU())
            cin = v
        self.features = Sequential(layers)
        self.avgpool = AdaptiveAvgPool7()
        self.flatten = Flatten()
        self.classifier = Sequential([
            Dense(cin * 49, 4096), ReLU(), Identity(),
            Dense(4096, 4096), ReLU(), Identity(),
            Dense(4096, num_classes)])
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.flatten(self.avgpool(self.features(x, ctx)))
        return self.classifier(x, ctx)


def vgg(arch: str, num_classes: int = 1000, batch_norm: bool = False,
        device=None) -> VGG:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return VGG(_CFGS[arch], num_classes, batch_norm).to(
        resolve_device(device))
