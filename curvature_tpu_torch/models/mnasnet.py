"""MNASNet (0.5, 0.75, 1.0, 1.3) with torchvision names.

Port of ``curvature_tpu/models/mnasnet.py``: torchvision names the trunk
one flat ``layers`` Sequential (``layers.0`` ... ``layers.16``), with the
inverted-residual stacks at ``layers.8``-``layers.13`` (each block a
nested ``layers`` Sequential: expand 1x1, depthwise kxk, project 1x1) and
the Linear at ``classifier.1``.
"""
from typing import Optional

from curvature_tpu_torch.models.blocks import ZooNet, make_divisible
from curvature_tpu_torch.nn import (
    BatchNorm, Context, Conv, CtxModule, Dense, GlobalAvgPool, Identity,
    ReLU, Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device


class _InvertedResidual(CtxModule):
    def __init__(self, inp: int, oup: int, kernel: int, stride: int,
                 expansion: int):
        super().__init__()
        self.use_res = inp == oup and stride == 1
        mid = inp * expansion
        self.layers = Sequential([
            Conv(inp, mid, 1, bias=False), BatchNorm(mid), ReLU(),
            Conv(mid, mid, kernel, stride, padding=kernel // 2,
                 bias=False, groups=mid), BatchNorm(mid), ReLU(),
            Conv(mid, oup, 1, bias=False), BatchNorm(oup)])
        if self.use_res:
            self.residual_bn = "layers.7"

    def forward(self, x, ctx: Optional[Context] = None):
        y = self.layers(x, ctx)
        return x + y if self.use_res else y


#: (kernel, stride, expansion, repeats) per stack at layers.8..13; the
#: base depths scale by alpha through make_divisible
_STACKS = ((3, 2, 3, 3), (5, 2, 3, 3), (5, 2, 6, 3),
           (3, 1, 6, 2), (5, 2, 6, 4), (3, 1, 6, 1))
_BASE_DEPTHS = (32, 16, 24, 40, 80, 96, 192, 320)


class MNASNet(ZooNet):
    def __init__(self, alpha: float, num_classes: int):
        super().__init__()
        d = [make_divisible(c * alpha) for c in _BASE_DEPTHS]
        layers = [Conv(3, d[0], 3, 2, padding=1, bias=False),
                  BatchNorm(d[0]), ReLU(),
                  Conv(d[0], d[0], 3, padding=1, bias=False, groups=d[0]),
                  BatchNorm(d[0]), ReLU(),
                  Conv(d[0], d[1], 1, bias=False), BatchNorm(d[1])]
        inp = d[1]
        for (k, s, t, n), oup in zip(_STACKS, d[2:]):
            blocks = []
            for j in range(n):
                blocks.append(_InvertedResidual(inp, oup, k,
                                                s if j == 0 else 1, t))
                inp = oup
            layers.append(Sequential(blocks))
        layers += [Conv(inp, 1280, 1, bias=False), BatchNorm(1280), ReLU()]
        self.layers = Sequential(layers)
        self.pool = GlobalAvgPool()
        self.classifier = Sequential([Identity(), Dense(1280, num_classes)])
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        return self.classifier(self.pool(self.layers(x, ctx)), ctx)


def mnasnet(alpha: float, num_classes: int = 1000, device=None) -> MNASNet:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return MNASNet(alpha, num_classes).to(resolve_device(device))


def mnasnet1_0(num_classes: int = 1000, device=None) -> MNASNet:
    return mnasnet(1.0, num_classes, device)
