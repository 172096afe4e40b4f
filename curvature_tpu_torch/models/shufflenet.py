"""ShuffleNetV2 (x0_5 to x2_0) with torchvision names.

Port of ``curvature_tpu/models/shufflenet.py``: depthwise-separable units
(the depthwise 3x3s through per-group block factors) joined by a channel
shuffle. Stride-1 units split the channels and transform one half;
stride-2 units run both branches on the whole input. Layer names are
torchvision's (``stage2.0.branch2.0``, ``conv5.0``, ``fc``).
"""
from typing import Optional

import torch

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    BatchNorm, Context, Conv, CtxModule, Dense, GlobalAvgPool, MaxPool,
    ReLU, Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """torchvision's ``channel_shuffle`` on NCHW: channel g * cpg + i
    moves to i * groups + g."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


def _unit(cin: int, cout: int, kernel_size: int, stride: int = 1,
          groups: int = 1, relu: bool = True):
    """A bias-free conv and its BN (and a ReLU), as flat Sequential
    entries."""
    layers = [Conv(cin, cout, kernel_size, stride,
                   padding=(kernel_size - 1) // 2, bias=False, groups=groups),
              BatchNorm(cout)]
    return layers + ([ReLU()] if relu else [])


class InvertedResidual(CtxModule):
    """``branch1`` (stride 2: depthwise, BN, 1x1, BN, ReLU) and
    ``branch2`` (1x1, BN, ReLU, depthwise, BN, 1x1, BN, ReLU), concatenated
    and shuffled with 2 groups."""

    def __init__(self, inp: int, oup: int, stride: int):
        super().__init__()
        self.stride = stride
        bf = oup // 2
        if stride > 1:
            self.branch1 = Sequential(_unit(inp, inp, 3, stride, inp, False)
                                      + _unit(inp, bf, 1))
        cin = inp if stride > 1 else bf
        self.branch2 = Sequential(_unit(cin, bf, 1)
                                  + _unit(bf, bf, 3, stride, bf, False)
                                  + _unit(bf, bf, 1))

    def forward(self, x, ctx: Optional[Context] = None):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2, ctx)], dim=1)
        else:
            out = torch.cat([self.branch1(x, ctx), self.branch2(x, ctx)],
                            dim=1)
        return channel_shuffle(out, 2)


#: arch -> (stage repeats, stage out-channels): torchvision's
_CONFIGS = {
    "shufflenet_v2_x0_5": ((4, 8, 4), (24, 48, 96, 192, 1024)),
    "shufflenet_v2_x1_0": ((4, 8, 4), (24, 116, 232, 464, 1024)),
    "shufflenet_v2_x1_5": ((4, 8, 4), (24, 176, 352, 704, 1024)),
    "shufflenet_v2_x2_0": ((4, 8, 4), (24, 244, 488, 976, 2048)),
}


class ShuffleNetV2(ZooNet):
    def __init__(self, repeats, channels, num_classes: int):
        super().__init__()
        self.conv1 = Sequential(_unit(3, channels[0], 3, 2))
        self.maxpool = MaxPool(3, 2, padding=1)
        inp = channels[0]
        for stage, (n, oup) in enumerate(zip(repeats, channels[1:4]),
                                         start=2):
            self.add_module(f"stage{stage}", Sequential([
                InvertedResidual(inp if i == 0 else oup, oup,
                                 2 if i == 0 else 1) for i in range(n)]))
            inp = oup
        self.conv5 = Sequential(_unit(inp, channels[4], 1))
        self.pool = GlobalAvgPool()
        self.fc = Dense(channels[4], num_classes)
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.maxpool(self.conv1(x, ctx))
        for stage in (self.stage2, self.stage3, self.stage4):
            x = stage(x, ctx)
        return self.fc(self.pool(self.conv5(x, ctx)), ctx)


def shufflenet_v2(arch: str, num_classes: int = 1000,
                  device=None) -> ShuffleNetV2:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    repeats, channels = _CONFIGS[arch]
    return ShuffleNetV2(repeats, channels, num_classes).to(
        resolve_device(device))


def shufflenet_v2_x1_0(num_classes: int = 1000, device=None
                       ) -> ShuffleNetV2:
    return shufflenet_v2("shufflenet_v2_x1_0", num_classes, device)
