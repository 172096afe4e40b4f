"""DenseNet-121/161/169/201 with torchvision names.

Port of ``curvature_tpu/models/densenet.py``: each dense layer is BN ->
ReLU -> 1x1 conv to ``bn_size * growth`` -> BN -> ReLU -> 3x3 conv to
``growth``, its output concatenated onto its input along the channels
(NCHW dim 1); a transition halves the channels by a 1x1 conv and the
extent by a 2x2 average pool. Layer names are torchvision's
(``features.denseblock1.denselayer1.conv1``, ``features.transition1.
conv``, ``classifier``), the JAX ``LayerMeta.name`` strings.
"""
from typing import Optional, Sequence

import torch

from curvature_tpu_torch.models.blocks import ZooNet, named
from curvature_tpu_torch.nn import (
    AvgPool, BatchNorm, Context, Conv, CtxModule, Dense, GlobalAvgPool,
    MaxPool, ReLU,
)
from curvature_tpu_torch.utils.device import resolve_device


class DenseLayer(CtxModule):
    def __init__(self, cin: int, growth: int, bn_size: int):
        super().__init__()
        self.norm1 = BatchNorm(cin)
        self.conv1 = Conv(cin, bn_size * growth, 1, bias=False)
        self.norm2 = BatchNorm(bn_size * growth)
        self.conv2 = Conv(bn_size * growth, growth, 3, padding=1, bias=False)
        self.relu = ReLU()

    def forward(self, x, ctx: Optional[Context] = None):
        out = self.conv1(self.relu(self.norm1(x, ctx)), ctx)
        out = self.conv2(self.relu(self.norm2(out, ctx)), ctx)
        return torch.cat([x, out], dim=1)


class DenseNet(ZooNet):
    def __init__(self, growth: int, blocks: Sequence[int],
                 init_features: int, num_classes: int, bn_size: int = 4):
        super().__init__()
        f = self.features = named(
            conv0=Conv(3, init_features, 7, 2, padding=3, bias=False),
            norm0=BatchNorm(init_features), relu0=ReLU(),
            pool0=MaxPool(3, 2, padding=1))
        feats = init_features
        for bi, n_layers in enumerate(blocks):
            block = {}
            for li in range(n_layers):
                block[f"denselayer{li + 1}"] = DenseLayer(feats, growth,
                                                          bn_size)
                feats += growth
            f.add_module(f"denseblock{bi + 1}", named(**block))
            if bi != len(blocks) - 1:
                # BN, ReLU, 1x1 conv, 2x2 average pool
                f.add_module(f"transition{bi + 1}", named(
                    norm=BatchNorm(feats), relu=ReLU(),
                    conv=Conv(feats, feats // 2, 1, bias=False),
                    pool=AvgPool(2, 2)))
                feats //= 2
        f.add_module("norm5", BatchNorm(feats))
        f.add_module("relu5", ReLU())
        self.pool = GlobalAvgPool()
        self.classifier = Dense(feats, num_classes)
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        return self.classifier(self.pool(self.features(x, ctx)), ctx)


#: arch -> (growth, blocks, init_features): torchvision's, as the JAX
#: table (densenet.py:82-87)
_CONFIGS = {
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
}


def densenet(arch: str, num_classes: int = 1000, device=None) -> DenseNet:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    growth, blocks, init = _CONFIGS[arch]
    return DenseNet(growth, blocks, init, num_classes).to(
        resolve_device(device))


def densenet121(num_classes: int = 1000, device=None) -> DenseNet:
    return densenet("densenet121", num_classes, device)


def densenet161(num_classes: int = 1000, device=None) -> DenseNet:
    return densenet("densenet161", num_classes, device)


def densenet169(num_classes: int = 1000, device=None) -> DenseNet:
    return densenet("densenet169", num_classes, device)


def densenet201(num_classes: int = 1000, device=None) -> DenseNet:
    return densenet("densenet201", num_classes, device)
