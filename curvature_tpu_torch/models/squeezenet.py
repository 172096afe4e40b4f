"""SqueezeNet 1.0 and 1.1 with torchvision names.

Port of ``curvature_tpu/models/squeezenet.py``: no BatchNorm, every conv
with a bias; Fire modules (squeeze 1x1 -> ReLU -> [expand 1x1 | expand
3x3], concatenated on the channels) at ``features.{i}``, 3x3 stride-2
max pools with ``ceil_mode`` wherever torchvision's ``Sequential`` skips
an index, and a 1x1 conv classifier (``classifier.1``) over the last map,
ReLU and the global mean.
"""
from typing import Optional

import torch

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    Context, Conv, CtxModule, GlobalAvgPool, Identity, MaxPool, ReLU,
    Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device


class Fire(CtxModule):
    """squeeze (1x1) -> ReLU -> [expand1x1 | expand3x3] -> ReLU, concat."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = Conv(cin, squeeze, 1)
        self.expand1x1 = Conv(squeeze, expand, 1)
        self.expand3x3 = Conv(squeeze, expand, 3, padding=1)
        self.relu = ReLU()

    def forward(self, x, ctx: Optional[Context] = None):
        s = self.relu(self.squeeze(x, ctx))
        return torch.cat([self.relu(self.expand1x1(s, ctx)),
                          self.relu(self.expand3x3(s, ctx))], dim=1)


#: arch -> (stem kernel, stem stride, stem features, fire plan: (feature
#: index, squeeze, expand)), torchvision's (JAX squeezenet.py:36-48)
_CONFIGS = {
    "squeezenet1_0": (7, 2, 96,
                      ((3, 16, 64), (4, 16, 64), (5, 32, 128),
                       (7, 32, 128), (8, 48, 192), (9, 48, 192),
                       (10, 64, 256), (12, 64, 256))),
    "squeezenet1_1": (3, 2, 64,
                      ((3, 16, 64), (4, 16, 64), (6, 32, 128),
                       (7, 32, 128), (9, 48, 192), (10, 48, 192),
                       (11, 64, 256), (12, 64, 256))),
}


def _pool():
    return MaxPool(3, 2, padding=0, ceil_mode=True)


class SqueezeNet(ZooNet):
    def __init__(self, arch: str, num_classes: int):
        super().__init__()
        kernel, stride, stem, plan = _CONFIGS[arch]
        layers = [Conv(3, stem, kernel, stride), ReLU(), _pool()]
        cin = stem
        for idx, sq, ex in plan:
            if idx > len(layers):       # a pool where torchvision has one
                layers.append(_pool())
            layers.append(Fire(cin, sq, ex))
            cin = 2 * ex
        self.features = Sequential(layers)
        # classifier.0 is torchvision's Dropout (an eval no-op)
        self.classifier = Sequential([Identity(), Conv(cin, num_classes, 1),
                                      ReLU(), GlobalAvgPool()])
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        return self.classifier(self.features(x, ctx), ctx)


def squeezenet(arch: str, num_classes: int = 1000,
               device=None) -> SqueezeNet:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return SqueezeNet(arch, num_classes).to(resolve_device(device))
