"""GoogLeNet (Inception v1) with torchvision names, no auxiliary heads.

Port of ``curvature_tpu/models/googlenet.py``: ``BasicConv2d`` is a
bias-free conv, BatchNorm with eps 1e-3 and ReLU (``{name}.conv``,
``{name}.bn``); each Inception block concatenates a 1x1 branch, 1x1 ->
3x3, 1x1 -> "5x5" (torchvision's is a 3x3) and a 3x3 max pool -> 1x1
(``inception3a.branch2.1.conv`` ...); the stage pools are 'SAME' max
pools, as in JAX (torchvision's ``ceil_mode`` pools give the same sizes
at 224).
"""
from typing import Optional

import torch

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    BatchNorm, Context, Conv, CtxModule, Dense, GlobalAvgPool, MaxPool, ReLU,
    Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device


class BasicConv2d(CtxModule):
    """Conv (no bias) + BatchNorm(eps=1e-3) + ReLU, torchvision-style;
    shared with Inception v3."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = Conv(cin, cout, kernel_size, stride, padding=padding,
                         bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)
        self.relu = ReLU()

    def forward(self, x, ctx: Optional[Context] = None):
        return self.relu(self.bn(self.conv(x, ctx), ctx))


class Inception(CtxModule):
    def __init__(self, cin: int, c1: int, c3r: int, c3: int, c5r: int,
                 c5: int, pool_proj: int):
        super().__init__()
        self.branch1 = BasicConv2d(cin, c1, 1)
        self.branch2 = Sequential([BasicConv2d(cin, c3r, 1),
                                   BasicConv2d(c3r, c3, 3, padding=1)])
        # torchvision's "5x5" branch is a 3x3 conv
        self.branch3 = Sequential([BasicConv2d(cin, c5r, 1),
                                   BasicConv2d(c5r, c5, 3, padding=1)])
        self.branch4 = Sequential([MaxPool(3, 1, padding=1),
                                   BasicConv2d(cin, pool_proj, 1)])
        self.out_channels = c1 + c3 + c5 + pool_proj

    def forward(self, x, ctx: Optional[Context] = None):
        return torch.cat([b(x, ctx) for b in (
            self.branch1, self.branch2, self.branch3, self.branch4)], dim=1)


#: name -> (c1, c3r, c3, c5r, c5, pool_proj), torchvision's (JAX
#: googlenet.py:60-72), with a 'SAME' max pool after 3b, 4e
_BLOCKS = (("inception3a", (64, 96, 128, 16, 32, 32)),
           ("inception3b", (128, 128, 192, 32, 96, 64)),
           ("inception4a", (192, 96, 208, 16, 48, 64)),
           ("inception4b", (160, 112, 224, 24, 64, 64)),
           ("inception4c", (128, 128, 256, 24, 64, 64)),
           ("inception4d", (112, 144, 288, 32, 64, 64)),
           ("inception4e", (256, 160, 320, 32, 128, 128)),
           ("inception5a", (256, 160, 320, 32, 128, 128)),
           ("inception5b", (384, 192, 384, 48, 128, 128)))
_POOL_AFTER = {"inception3b": ("maxpool3", 3), "inception4e": ("maxpool4", 2)}


class GoogLeNet(ZooNet):
    def __init__(self, num_classes: int):
        super().__init__()
        self.conv1 = BasicConv2d(3, 64, 7, 2, padding=3)
        self.maxpool1 = MaxPool(3, 2, padding="SAME")
        self.conv2 = BasicConv2d(64, 64, 1)
        self.conv3 = BasicConv2d(64, 192, 3, padding=1)
        self.maxpool2 = MaxPool(3, 2, padding="SAME")
        self.stages = []
        cin = 192
        for name, widths in _BLOCKS:
            block = Inception(cin, *widths)
            self.add_module(name, block)
            self.stages.append(block)
            cin = block.out_channels
            if name in _POOL_AFTER:
                pool_name, k = _POOL_AFTER[name]
                pool = MaxPool(k, 2, padding="SAME")
                self.add_module(pool_name, pool)
                self.stages.append(pool)
        self.pool = GlobalAvgPool()
        self.fc = Dense(cin, num_classes)
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.maxpool1(self.conv1(x, ctx))
        x = self.maxpool2(self.conv3(self.conv2(x, ctx), ctx))
        for stage in self.stages:
            x = stage(x, ctx) if isinstance(stage, CtxModule) else stage(x)
        return self.fc(self.pool(x), ctx)


def googlenet(num_classes: int = 1000, device=None) -> GoogLeNet:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return GoogLeNet(num_classes).to(resolve_device(device))
