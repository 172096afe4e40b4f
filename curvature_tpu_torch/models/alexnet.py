"""AlexNet with torchvision names.

Port of ``curvature_tpu/models/alexnet.py``: five convs with bias at
``features.0``/``3``/``6``/``8``/``10``, 3x3 stride-2 max pools, the
6x6 adaptive pool, a channel-major flatten and three dense layers at
``classifier.1``/``4``/``6`` (the dropouts are eval no-ops). The input
must be at least 63x63.
"""
from typing import Optional

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    AdaptiveAvgPool, Context, Conv, Dense, Flatten, Identity, MaxPool, ReLU,
    Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device


class AlexNet(ZooNet):
    def __init__(self, num_classes: int):
        super().__init__()
        self.features = Sequential([
            Conv(3, 64, 11, 4, padding=2), ReLU(), MaxPool(3, 2),
            Conv(64, 192, 5, padding=2), ReLU(), MaxPool(3, 2),
            Conv(192, 384, 3, padding=1), ReLU(),
            Conv(384, 256, 3, padding=1), ReLU(),
            Conv(256, 256, 3, padding=1), ReLU(), MaxPool(3, 2)])
        self.avgpool = AdaptiveAvgPool(6)
        self.flatten = Flatten()
        self.classifier = Sequential([
            Identity(), Dense(256 * 36, 4096), ReLU(),
            Identity(), Dense(4096, 4096), ReLU(),
            Dense(4096, num_classes)])
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.flatten(self.avgpool(self.features(x, ctx)))
        return self.classifier(x, ctx)


def alexnet(num_classes: int = 1000, device=None) -> AlexNet:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return AlexNet(num_classes).to(resolve_device(device))
