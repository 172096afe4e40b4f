"""Inception v3 with torchvision names, no auxiliary head, at 299x299.

Port of ``curvature_tpu/models/inception.py``: the A-E blocks of
``BasicConv2d`` branches (``Mixed_5b.branch5x5_2.conv`` ...), 1x7 and 7x1
convs with asymmetric padding ((0, 3) / (3, 0)), 3x3 average pools of
stride 1 and padding 1 divided by the full window, 3x3 stride-2 max
pools, concatenations on the channels.
"""
from typing import Optional

import torch

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.models.googlenet import BasicConv2d
from curvature_tpu_torch.nn import (
    AvgPool, Context, CtxModule, Dense, GlobalAvgPool, MaxPool,
)
from curvature_tpu_torch.utils.device import resolve_device


class _Block(CtxModule):
    """A mixed block: ``branches`` lists the chains of attribute names
    whose outputs are concatenated; a chain's name ``"pool"`` is the
    block's pool, a tuple of names forks (InceptionE's split 1x3 / 3x1
    pairs, concatenated in that order)."""
    branches = ()

    def forward(self, x, ctx: Optional[Context] = None):
        outs = []
        for chain in self.branches:
            y = x
            for name in chain:
                if isinstance(name, tuple):
                    y = torch.cat([getattr(self, n)(y, ctx) for n in name],
                                  dim=1)
                elif name == "pool":
                    y = self.pool(y)
                else:
                    y = getattr(self, name)(y, ctx)
            outs.append(y)
        return torch.cat(outs, dim=1)


class InceptionA(_Block):
    branches = (("branch1x1",), ("branch5x5_1", "branch5x5_2"),
                ("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                ("pool", "branch_pool"))

    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.pool = AvgPool(3, 1, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)
        self.out_channels = 224 + pool_features


class InceptionB(_Block):
    branches = (("branch3x3",),
                ("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                ("pool",))

    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, 2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 2)
        self.pool = MaxPool(3, 2)
        self.out_channels = 480 + cin


class InceptionC(_Block):
    branches = (("branch1x1",),
                ("branch7x7_1", "branch7x7_2", "branch7x7_3"),
                ("branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                 "branch7x7dbl_4", "branch7x7dbl_5"),
                ("pool", "branch_pool"))

    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.pool = AvgPool(3, 1, padding=1)
        self.branch_pool = BasicConv2d(cin, 192, 1)
        self.out_channels = 768


class InceptionD(_Block):
    branches = (("branch3x3_1", "branch3x3_2"),
                ("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                 "branch7x7x3_4"),
                ("pool",))

    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 2)
        self.pool = MaxPool(3, 2)
        self.out_channels = 512 + cin


class InceptionE(_Block):
    branches = (("branch1x1",),
                ("branch3x3_1", ("branch3x3_2a", "branch3x3_2b")),
                ("branch3x3dbl_1", "branch3x3dbl_2",
                 ("branch3x3dbl_3a", "branch3x3dbl_3b")),
                ("pool", "branch_pool"))

    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.pool = AvgPool(3, 1, padding=1)
        self.branch_pool = BasicConv2d(cin, 192, 1)
        self.out_channels = 2048


class InceptionV3(ZooNet):
    def __init__(self, num_classes: int):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.maxpool1 = MaxPool(3, 2)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.maxpool2 = MaxPool(3, 2)
        self.mixed = []
        cin = 192
        for name, make in (
                ("Mixed_5b", lambda c: InceptionA(c, 32)),
                ("Mixed_5c", lambda c: InceptionA(c, 64)),
                ("Mixed_5d", lambda c: InceptionA(c, 64)),
                ("Mixed_6a", InceptionB),
                ("Mixed_6b", lambda c: InceptionC(c, 128)),
                ("Mixed_6c", lambda c: InceptionC(c, 160)),
                ("Mixed_6d", lambda c: InceptionC(c, 160)),
                ("Mixed_6e", lambda c: InceptionC(c, 192)),
                ("Mixed_7a", InceptionD),
                ("Mixed_7b", InceptionE),
                ("Mixed_7c", InceptionE)):
            block = make(cin)
            self.add_module(name, block)
            self.mixed.append(block)
            cin = block.out_channels
        self.pool = GlobalAvgPool()
        self.fc = Dense(cin, num_classes)
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(
            self.Conv2d_1a_3x3(x, ctx), ctx), ctx)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(self.maxpool1(x), ctx),
                               ctx)
        x = self.maxpool2(x)
        for block in self.mixed:
            x = block(x, ctx)
        return self.fc(self.pool(x), ctx)


def inception_v3(num_classes: int = 1000, device=None) -> InceptionV3:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return InceptionV3(num_classes).to(resolve_device(device))
