"""ResNet family (BasicBlock / Bottleneck) with torchvision names, and its
``groups``/``base_width`` axis: ResNeXt and Wide ResNet.

Port of ``curvature_tpu/models/resnet.py``: ``resnet18`` (CIFAR stem:
3x3 stride-1 conv, maxpool kept), ``resnet34``/``50``/``101``/``152``
(ImageNet stem), ``resnext50_32x4d``, ``resnext101_32x8d``,
``resnext101_64x4d`` (grouped 3x3 convs in every Bottleneck),
``wide_resnet50_2`` and ``wide_resnet101_2``. Tracked layers are named by
their torchvision state-dict paths (``"layer1.0.conv2"``), the JAX
``LayerMeta.name`` strings, and ``ResNet.metas`` lists them in forward
order, as the JAX model does.
"""
from typing import Optional, Sequence

from torch import nn

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    BatchNorm, Context, Conv, Dense, GlobalAvgPool, MaxPool, ReLU,
)
from curvature_tpu_torch.utils.device import resolve_device


class BasicBlock(nn.Module):
    expansion = 1
    #: the last BN of the residual branch (models.convert.seeded_variables)
    residual_bn = "bn2"

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.relu = ReLU()
        self.downsample = nn.ModuleList([
            Conv(inplanes, planes, 1, stride, bias=False),
            BatchNorm(planes)]) if downsample else None

    def forward(self, x, ctx: Optional[Context] = None):
        identity = x
        out = self.relu(self.bn1(self.conv1(x, ctx), ctx))
        out = self.bn2(self.conv2(out, ctx), ctx)
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](x, ctx), ctx)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (grouped for ResNeXt) -> 1x1; the width follows
    torchvision's rule, int(planes * base_width / 64) * groups."""
    expansion = 4
    residual_bn = "bn3"

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv(width, width, 3, stride, padding=1, bias=False,
                          groups=groups)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv(width, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.relu = ReLU()
        self.downsample = nn.ModuleList([
            Conv(inplanes, planes * 4, 1, stride, bias=False),
            BatchNorm(planes * 4)]) if downsample else None

    def forward(self, x, ctx: Optional[Context] = None):
        identity = x
        out = self.relu(self.bn1(self.conv1(x, ctx), ctx))
        out = self.relu(self.bn2(self.conv2(out, ctx), ctx))
        out = self.bn3(self.conv3(out, ctx), ctx)
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](x, ctx), ctx)
        return self.relu(out + identity)


class ResNet(ZooNet):
    def __init__(self, block, layers: Sequence[int], num_classes: int,
                 stem: str, groups: int = 1, base_width: int = 64):
        super().__init__()
        if (groups != 1 or base_width != 64) and block is not Bottleneck:
            raise ValueError("groups/base_width require Bottleneck blocks "
                             "(reference resnet.py:32-33)")
        block_kw = ({"groups": groups, "base_width": base_width}
                    if block is Bottleneck else {})
        if stem == "cifar":
            self.conv1 = Conv(3, 64, 3, 1, padding=1, bias=False)
            # the stride-1 stem keeps every pixel: its sampled ensembles
            # run under vmap up to 32² an image (eval/evaluate.py's
            # vmaps; on the H100 ResNet-18's vmapped call was faster at
            # 32², the member loop at 64²)
            self.vmap_max_pixels = 32 * 32
        else:
            self.conv1 = Conv(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.relu = ReLU()
        self.maxpool = MaxPool(3, 2, padding=1)
        inplanes = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                downsample = i == 0 and (
                    stride != 1 or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, stride, downsample,
                                    **block_kw))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.ModuleList(blocks))
        self.pool = GlobalAvgPool()
        self.fc = Dense(inplanes, num_classes)
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.relu(self.bn1(self.conv1(x, ctx), ctx))
        x = self.maxpool(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for blk in stage:
                x = blk(x, ctx)
        return self.fc(self.pool(x), ctx)


#: arch -> (block, layers, groups, width_per_group): torchvision's widths,
#: as the JAX table (resnet.py:126-145)
_CONFIGS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
    "resnext101_64x4d": (Bottleneck, (3, 4, 23, 3), 64, 4),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), 1, 128),
}


def resnet(arch: str, num_classes: int = 1000, stem: str = "imagenet",
           device=None) -> ResNet:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    block, layers, groups, width = _CONFIGS[arch]
    return ResNet(block, layers, num_classes, stem, groups=groups,
                  base_width=width).to(device)


def resnet18(num_classes: int = 10, stem: str = "cifar",
             device=None) -> ResNet:
    """Default mirrors the reference's CIFAR/GTSRB variant."""
    return resnet("resnet18", num_classes, stem, device)


def resnet50(num_classes: int = 1000, stem: str = "imagenet",
             device=None) -> ResNet:
    return resnet("resnet50", num_classes, stem, device)


def resnet34(num_classes: int = 1000, stem: str = "imagenet",
             device=None) -> ResNet:
    return resnet("resnet34", num_classes, stem, device)


def resnet101(num_classes: int = 1000, stem: str = "imagenet",
              device=None) -> ResNet:
    return resnet("resnet101", num_classes, stem, device)


def resnet152(num_classes: int = 1000, stem: str = "imagenet",
              device=None) -> ResNet:
    return resnet("resnet152", num_classes, stem, device)
