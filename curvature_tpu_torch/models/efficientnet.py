"""EfficientNet B0-B7 and EfficientNetV2 (S, M, L) with torchvision names.

Port of ``curvature_tpu/models/efficientnet.py``. Every MBConv block is
expand 1x1 -> depthwise kxk (per-group block factors in KFAC, EFB and
INF) -> squeeze-excitation (SiLU, sigmoid gate; its fc1/fc2 are tracked
1x1 convs) -> project 1x1; V2's early FusedMBConv blocks merge expand and
depthwise into one dense kxk conv. B1-B7 scale B0's widths by
make_divisible(c * w) and depths by ceil(n * d). BatchNorm eps is 1e-5 in
B0-B7 and 1e-3 in V2, as torchvision. Layer names are torchvision's
(``features.1.0.block.0.0``, ``features.8.0``, ``classifier.1``).
"""
import math
from typing import Optional

from curvature_tpu_torch.models.blocks import (
    SqueezeExcitation, ZooNet, conv_bn, make_divisible)
from curvature_tpu_torch.nn import (
    Context, CtxModule, Dense, GlobalAvgPool, Identity, Sequential, SiLU,
)
from curvature_tpu_torch.utils.device import resolve_device


class MBConv(CtxModule):
    """``block.{k}``: expand (with t > 1), depthwise, SE (squeeze width
    max(1, inp // 4), from the unexpanded input), project (no
    activation); a residual where the stride is 1 and the channels match
    (stochastic depth is an eval no-op)."""

    def __init__(self, inp: int, oup: int, kernel: int, stride: int,
                 expand_ratio: int, bn_eps: float = 1e-5):
        super().__init__()
        self.use_res = stride == 1 and inp == oup
        expanded = make_divisible(inp * expand_ratio)
        layers = []
        if expanded != inp:
            layers.append(conv_bn(inp, expanded, 1, act=SiLU(), eps=bn_eps))
        layers += [conv_bn(expanded, expanded, kernel, stride, expanded,
                           SiLU(), bn_eps),
                   SqueezeExcitation(expanded, max(1, inp // 4), SiLU()),
                   conv_bn(expanded, oup, 1, eps=bn_eps)]
        self.block = Sequential(layers)
        if self.use_res:
            self.residual_bn = f"block.{len(layers) - 1}.1"

    def forward(self, x, ctx: Optional[Context] = None):
        y = self.block(x, ctx)
        return x + y if self.use_res else y


class FusedMBConv(CtxModule):
    """EfficientNetV2's fused block (no SE): a dense kxk expand at
    ``block.0`` and the 1x1 project at ``block.1``; without expansion a
    single kxk unit at ``block.0``."""

    def __init__(self, inp: int, oup: int, kernel: int, stride: int,
                 expand_ratio: int, bn_eps: float = 1e-3):
        super().__init__()
        self.use_res = stride == 1 and inp == oup
        expanded = make_divisible(inp * expand_ratio)
        if expanded != inp:
            layers = [conv_bn(inp, expanded, kernel, stride, act=SiLU(),
                              eps=bn_eps),
                      conv_bn(expanded, oup, 1, eps=bn_eps)]
        else:
            layers = [conv_bn(inp, oup, kernel, stride, eps=bn_eps)]
        self.block = Sequential(layers)
        if self.use_res:
            self.residual_bn = f"block.{len(layers) - 1}.1"

    def forward(self, x, ctx: Optional[Context] = None):
        y = self.block(x, ctx)
        return x + y if self.use_res else y


#: (expand_ratio t, kernel k, first-stride s, channels c, repeats n): B0's
#: stage table (torchvision _efficientnet_conf)
_SETTINGS = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

#: arch -> (width_mult, depth_mult), torchvision's compound scalings
_ARCH = {
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2),
    "efficientnet_b3": (1.2, 1.4),
    "efficientnet_b4": (1.4, 1.8),
    "efficientnet_b5": (1.6, 2.2),
    "efficientnet_b6": (1.8, 2.6),
    "efficientnet_b7": (2.0, 3.1),
}

#: EfficientNetV2 stage tables (torchvision _efficientnet_conf "v2_s"...):
#: (block kind, expand t, kernel k, stride s, in, out, repeats)
_V2_CONFIGS = {
    "efficientnet_v2_s": (
        ("fused", 1, 3, 1, 24, 24, 2),
        ("fused", 4, 3, 2, 24, 48, 4),
        ("fused", 4, 3, 2, 48, 64, 4),
        ("mb", 4, 3, 2, 64, 128, 6),
        ("mb", 6, 3, 1, 128, 160, 9),
        ("mb", 6, 3, 2, 160, 256, 15),
    ),
    "efficientnet_v2_m": (
        ("fused", 1, 3, 1, 24, 24, 3),
        ("fused", 4, 3, 2, 24, 48, 5),
        ("fused", 4, 3, 2, 48, 80, 5),
        ("mb", 4, 3, 2, 80, 160, 7),
        ("mb", 6, 3, 1, 160, 176, 14),
        ("mb", 6, 3, 2, 176, 304, 18),
        ("mb", 6, 3, 1, 304, 512, 5),
    ),
    "efficientnet_v2_l": (
        ("fused", 1, 3, 1, 32, 32, 4),
        ("fused", 4, 3, 2, 32, 64, 7),
        ("fused", 4, 3, 2, 64, 96, 7),
        ("mb", 4, 3, 2, 96, 192, 10),
        ("mb", 6, 3, 1, 192, 224, 19),
        ("mb", 6, 3, 2, 224, 384, 25),
        ("mb", 6, 3, 1, 384, 640, 7),
    ),
}


class EfficientNet(ZooNet):
    """``features`` = stem, one Sequential of blocks per stage, head;
    ``classifier`` = Dropout (an eval no-op), Linear."""

    def __init__(self, arch: str, num_classes: int):
        super().__init__()
        if arch in _V2_CONFIGS:
            eps, table = 1e-3, _V2_CONFIGS[arch]
            stages = [[(FusedMBConv if kind == "fused" else MBConv)(
                ci if j == 0 else co, co, k, s if j == 0 else 1, t,
                bn_eps=eps) for j in range(n)]
                for kind, t, k, s, ci, co, n in table]
            stem, last_in, head = table[0][4], table[-1][5], 1280
        else:
            width, depth = _ARCH[arch]
            eps, stages, inp = 1e-5, [], make_divisible(32 * width)
            stem = inp
            for t, k, s, c, n in _SETTINGS:
                oup = make_divisible(c * width)
                blocks = []
                for j in range(int(math.ceil(n * depth))):
                    blocks.append(MBConv(inp, oup, k, s if j == 0 else 1, t))
                    inp = oup
                stages.append(blocks)
            last_in, head = inp, 4 * inp
        self.features = Sequential(
            [conv_bn(3, stem, 3, 2, act=SiLU(), eps=eps)]
            + [Sequential(blocks) for blocks in stages]
            + [conv_bn(last_in, head, 1, act=SiLU(), eps=eps)])
        self.pool = GlobalAvgPool()
        self.classifier = Sequential([Identity(), Dense(head, num_classes)])
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        return self.classifier(self.pool(self.features(x, ctx)), ctx)


def efficientnet(arch: str, num_classes: int = 1000,
                 device=None) -> EfficientNet:
    """Build ``efficientnet_b0``-``b7`` or ``efficientnet_v2_{s,m,l}`` on
    ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return EfficientNet(arch, num_classes).to(resolve_device(device))


def efficientnet_b0(num_classes: int = 1000, device=None) -> EfficientNet:
    return efficientnet("efficientnet_b0", num_classes, device)
