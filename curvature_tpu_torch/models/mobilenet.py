"""MobileNetV2 and MobileNetV3 (large, small) with torchvision names.

Port of ``curvature_tpu/models/mobilenet.py``: inverted residual blocks,
expand 1x1 -> depthwise kxk (``groups`` = channels, per-group block
factors in KFAC, EFB and INF) -> project 1x1, with a residual where the
stride is 1 and the channels match; V3 adds Hardswish and a
squeeze-excitation whose gate is Hardsigmoid. Layer names are
torchvision's (``features.1.conv.0.0``, ``classifier.1``).
"""
from typing import Optional

from curvature_tpu_torch.models.blocks import (
    SqueezeExcitation, ZooNet, conv_bn, make_divisible)
from curvature_tpu_torch.nn import (
    BatchNorm, Context, Conv, CtxModule, Dense, GlobalAvgPool, Hardsigmoid,
    Hardswish, Identity, ReLU, ReLU6, Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device


class InvertedResidual(CtxModule):
    """MobileNetV2's block: ``conv`` holds expand (with t > 1) at
    ``conv.0``, the depthwise at the next index, then the project conv
    and its BN."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int):
        super().__init__()
        self.use_res = stride == 1 and inp == oup
        hidden = int(round(inp * expand_ratio))
        layers = []
        if expand_ratio != 1:
            layers.append(conv_bn(inp, hidden, 1, act=ReLU6()))
        layers += [conv_bn(hidden, hidden, 3, stride, hidden, ReLU6()),
                   Conv(hidden, oup, 1, bias=False), BatchNorm(oup)]
        self.conv = Sequential(layers)
        if self.use_res:
            self.residual_bn = f"conv.{len(layers) - 1}"

    def forward(self, x, ctx: Optional[Context] = None):
        y = self.conv(x, ctx)
        return x + y if self.use_res else y


#: (expand_ratio t, channels c, repeats n, first-stride s): torchvision's
#: inverted_residual_setting
_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2(ZooNet):
    def __init__(self, num_classes: int, width_mult: float = 1.0):
        super().__init__()
        inp = make_divisible(32 * width_mult)
        last = make_divisible(1280 * max(1.0, width_mult))
        features = [conv_bn(3, inp, 3, 2, act=ReLU6())]
        for t, c, n, s in _SETTINGS:
            oup = make_divisible(c * width_mult)
            for i in range(n):
                features.append(InvertedResidual(inp, oup, s if i == 0
                                                 else 1, t))
                inp = oup
        features.append(conv_bn(inp, last, 1, act=ReLU6()))
        self.features = Sequential(features)
        self.pool = GlobalAvgPool()
        # classifier.0 is torchvision's Dropout (an eval no-op)
        self.classifier = Sequential([Identity(), Dense(last, num_classes)])
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        return self.classifier(self.pool(self.features(x, ctx)), ctx)


def mobilenet_v2(num_classes: int = 1000, width_mult: float = 1.0,
                 device=None) -> MobileNetV2:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return MobileNetV2(num_classes, width_mult).to(resolve_device(device))


class V3InvertedResidual(CtxModule):
    """MobileNetV3's block: expand (where the width changes), depthwise,
    squeeze-excitation (where ``use_se``; squeeze width
    make_divisible(expanded / 4)), project, in ``block.{k}``."""

    def __init__(self, inp: int, kernel: int, expanded: int, oup: int,
                 use_se: bool, act: str, stride: int):
        super().__init__()
        self.use_res = stride == 1 and inp == oup

        def a():
            return Hardswish() if act == "hswish" else ReLU()
        layers = []
        if expanded != inp:
            layers.append(conv_bn(inp, expanded, 1, act=a()))
        layers.append(conv_bn(expanded, expanded, kernel, stride, expanded,
                              a()))
        if use_se:
            layers.append(SqueezeExcitation(
                expanded, make_divisible(expanded // 4), ReLU(),
                Hardsigmoid()))
        layers.append(conv_bn(expanded, oup, 1))
        self.block = Sequential(layers)
        if self.use_res:
            self.residual_bn = f"block.{len(layers) - 1}.1"

    def forward(self, x, ctx: Optional[Context] = None):
        y = self.block(x, ctx)
        return x + y if self.use_res else y


#: (input, kernel, expanded, out, use_se, act, stride): torchvision's
#: _mobilenet_v3_conf at width_mult=1.0
_V3_LARGE = (
    (16, 3, 16, 16, False, "relu", 1),
    (16, 3, 64, 24, False, "relu", 2),
    (24, 3, 72, 24, False, "relu", 1),
    (24, 5, 72, 40, True, "relu", 2),
    (40, 5, 120, 40, True, "relu", 1),
    (40, 5, 120, 40, True, "relu", 1),
    (40, 3, 240, 80, False, "hswish", 2),
    (80, 3, 200, 80, False, "hswish", 1),
    (80, 3, 184, 80, False, "hswish", 1),
    (80, 3, 184, 80, False, "hswish", 1),
    (80, 3, 480, 112, True, "hswish", 1),
    (112, 3, 672, 112, True, "hswish", 1),
    (112, 5, 672, 160, True, "hswish", 2),
    (160, 5, 960, 160, True, "hswish", 1),
    (160, 5, 960, 160, True, "hswish", 1),
)
_V3_SMALL = (
    (16, 3, 16, 16, True, "relu", 2),
    (16, 3, 72, 24, False, "relu", 2),
    (24, 3, 88, 24, False, "relu", 1),
    (24, 5, 96, 40, True, "hswish", 2),
    (40, 5, 240, 40, True, "hswish", 1),
    (40, 5, 240, 40, True, "hswish", 1),
    (40, 5, 120, 48, True, "hswish", 1),
    (48, 5, 144, 48, True, "hswish", 1),
    (48, 5, 288, 96, True, "hswish", 2),
    (96, 5, 576, 96, True, "hswish", 1),
    (96, 5, 576, 96, True, "hswish", 1),
)


class MobileNetV3(ZooNet):
    def __init__(self, settings, last_channel: int, num_classes: int):
        super().__init__()
        features = [conv_bn(3, settings[0][0], 3, 2, act=Hardswish())]
        features += [V3InvertedResidual(*cnf) for cnf in settings]
        lastconv_in = settings[-1][3]
        features.append(conv_bn(lastconv_in, 6 * lastconv_in, 1,
                                act=Hardswish()))
        self.features = Sequential(features)
        self.pool = GlobalAvgPool()
        # Linear / Hardswish / Dropout (an eval no-op) / Linear
        self.classifier = Sequential([
            Dense(6 * lastconv_in, last_channel), Hardswish(), Identity(),
            Dense(last_channel, num_classes)])
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        return self.classifier(self.pool(self.features(x, ctx)), ctx)


def mobilenet_v3_large(num_classes: int = 1000, device=None) -> MobileNetV3:
    return MobileNetV3(_V3_LARGE, 1280, num_classes).to(
        resolve_device(device))


def mobilenet_v3_small(num_classes: int = 1000, device=None) -> MobileNetV3:
    return MobileNetV3(_V3_SMALL, 1024, num_classes).to(
        resolve_device(device))
