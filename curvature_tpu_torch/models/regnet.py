"""RegNet X and Y with torchvision names.

Port of ``curvature_tpu/models/regnet.py``. Every block's 3x3 bottleneck
conv is grouped (``group_width`` channels per group: per-group block
factors); the Y variants add a squeeze-excitation whose fc1/fc2 are
tracked 1x1 convs. The widths follow torchvision's quantized log-space
generator (``block_params``). Layer names are torchvision's
(``trunk_output.block1.block1-0.f.a.0``, ``stem.0``, ``fc``).
"""
import math
from typing import Optional

from curvature_tpu_torch.models.blocks import (
    SqueezeExcitation, ZooNet, conv_bn)
from curvature_tpu_torch.nn import (
    Context, CtxModule, Dense, GlobalAvgPool, ReLU, Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device


def _quantize_float(f: float, q: int) -> int:
    return int(round(f / q) * q)


def block_params(depth: int, w_0: int, w_a: float, w_m: float,
                 group_width: int):
    """torchvision's ``BlockParams.from_init_params`` (JAX regnet.py:29-51):
    widths w_0 + w_a*i quantized to powers of w_m (multiples of 8), split
    into stages where the width changes, then made group-compatible
    (bottleneck ratio 1). Returns (stage widths, stage depths, group
    widths)."""
    quant = 8
    widths_cont = [w_0 + w_a * i for i in range(depth)]
    caps = [round(math.log(w / w_0) / math.log(w_m)) for w in widths_cont]
    block_widths = [int(round(w_0 * w_m ** c / quant) * quant) for c in caps]
    stage_widths, stage_depths = [], []
    for w in block_widths:
        if not stage_widths or stage_widths[-1] != w:
            stage_widths.append(w)
            stage_depths.append(1)
        else:
            stage_depths[-1] += 1
    gws = [min(group_width, w) for w in stage_widths]
    stage_widths = [_quantize_float(w, g) for w, g in zip(stage_widths, gws)]
    return stage_widths, stage_depths, gws


class _Bottleneck(CtxModule):
    """``f``: a (1x1) -> b (grouped 3x3) -> se -> c (1x1, no activation),
    torchvision's ``BottleneckTransform`` names."""

    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 se_ratio: float):
        super().__init__()
        self.a = conv_bn(w_in, w_out, 1, act=ReLU())
        self.b = conv_bn(w_out, w_out, 3, stride, w_out // group_width,
                         ReLU())
        # squeeze width from the block's input width (torchvision)
        self.se = (SqueezeExcitation(w_out, int(round(se_ratio * w_in)))
                   if se_ratio else None)
        self.c = conv_bn(w_out, w_out, 1)

    def forward(self, x, ctx: Optional[Context] = None):
        y = self.b(self.a(x, ctx), ctx)
        if self.se is not None:
            y = self.se(y, ctx)
        return self.c(y, ctx)


class ResBottleneckBlock(CtxModule):
    """``f`` + ``proj`` (1x1, where the width or stride changes), ReLU
    after the sum; ``f`` is registered and run first, the JAX layer
    order."""
    residual_bn = "f.c.1"

    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 se_ratio: float):
        super().__init__()
        self.f = _Bottleneck(w_in, w_out, stride, group_width, se_ratio)
        self.proj = (conv_bn(w_in, w_out, 1, stride)
                     if w_in != w_out or stride != 1 else None)
        self.relu = ReLU()

    def forward(self, x, ctx: Optional[Context] = None):
        y = self.f(x, ctx)
        shortcut = x if self.proj is None else self.proj(x, ctx)
        return self.relu(shortcut + y)


#: arch -> (depth, w_0, w_a, w_m, group_width, se_ratio): torchvision's
#: _regnet table
_CONFIGS = {
    "regnet_y_400mf": (16, 48, 27.89, 2.09, 8, 0.25),
    "regnet_y_800mf": (14, 56, 38.84, 2.4, 16, 0.25),
    "regnet_y_1_6gf": (27, 48, 20.71, 2.65, 24, 0.25),
    "regnet_y_3_2gf": (21, 80, 42.63, 2.66, 24, 0.25),
    "regnet_y_8gf": (17, 192, 76.82, 2.19, 56, 0.25),
    "regnet_y_16gf": (18, 200, 106.23, 2.48, 112, 0.25),
    "regnet_y_32gf": (20, 232, 115.89, 2.53, 232, 0.25),
    "regnet_y_128gf": (27, 456, 160.83, 2.52, 264, 0.25),
    "regnet_x_400mf": (22, 24, 24.48, 2.54, 16, 0.0),
    "regnet_x_800mf": (16, 56, 35.73, 2.28, 16, 0.0),
    "regnet_x_1_6gf": (18, 80, 34.01, 2.25, 24, 0.0),
    "regnet_x_3_2gf": (25, 88, 26.31, 2.25, 48, 0.0),
    "regnet_x_8gf": (23, 80, 49.56, 2.88, 120, 0.0),
    "regnet_x_16gf": (22, 216, 55.59, 2.1, 128, 0.0),
    "regnet_x_32gf": (23, 320, 69.86, 2.0, 168, 0.0),
}


class RegNet(ZooNet):
    def __init__(self, arch: str, num_classes: int):
        super().__init__()
        depth, w_0, w_a, w_m, gw, se_ratio = _CONFIGS[arch]
        widths, depths, gws = block_params(depth, w_0, w_a, w_m, gw)
        self.stem = conv_bn(3, 32, 3, 2, act=ReLU())
        self.trunk_output = Sequential([])
        w_in = 32
        for s, (w, d, g) in enumerate(zip(widths, depths, gws), start=1):
            stage = Sequential([])
            for j in range(d):
                stage.add_module(f"block{s}-{j}", ResBottleneckBlock(
                    w_in, w, 2 if j == 0 else 1, g, se_ratio))
                w_in = w
            self.trunk_output.add_module(f"block{s}", stage)
        self.pool = GlobalAvgPool()
        self.fc = Dense(w_in, num_classes)
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.trunk_output(self.stem(x, ctx), ctx)
        return self.fc(self.pool(x), ctx)


def regnet(arch: str, num_classes: int = 1000, device=None) -> RegNet:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return RegNet(arch, num_classes).to(resolve_device(device))
