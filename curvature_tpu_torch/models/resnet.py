"""ResNet (BasicBlock / Bottleneck, groups=1) with torchvision names.

Port of ``curvature_tpu/models/resnet.py`` for ``resnet18`` (CIFAR stem:
3x3 stride-1 conv, maxpool kept) and ``resnet50`` (ImageNet stem). Tracked
layers are named by their torchvision state-dict paths
(``"layer1.0.conv2"``), the JAX ``LayerMeta.name`` strings, and
``ResNet.metas`` lists them in forward order, as the JAX model does.
"""
from typing import Dict, Optional, Sequence

from torch import nn

from curvature_tpu_torch.nn import (
    BatchNorm, Context, Conv, Dense, GlobalAvgPool, LayerMeta, MaxPool, ReLU,
)
from curvature_tpu_torch.utils.device import resolve_device


class BasicBlock(nn.Module):
    expansion = 1

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
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
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


class ResNet(nn.Module):
    def __init__(self, block, layers: Sequence[int], num_classes: int,
                 stem: str):
        super().__init__()
        if stem == "cifar":
            self.conv1 = Conv(3, 64, 3, 1, padding=1, bias=False)
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
                blocks.append(block(inplanes, planes, stride, downsample))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.ModuleList(blocks))
        self.pool = GlobalAvgPool()
        self.fc = Dense(inplanes, num_classes)
        for name, m in self.named_modules():
            if isinstance(m, (Conv, Dense)):
                m.name = name

    @property
    def metas(self) -> Dict[str, LayerMeta]:
        """Tracked layers in forward order (module registration order)."""
        return {m.name: m.meta for m in self.modules()
                if isinstance(m, (Conv, Dense))}

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.relu(self.bn1(self.conv1(x, ctx), ctx))
        x = self.maxpool(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for blk in stage:
                x = blk(x, ctx)
        return self.fc(self.pool(x), ctx)


_CONFIGS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def resnet(arch: str, num_classes: int = 1000, stem: str = "imagenet",
           device=None) -> ResNet:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    block, layers = _CONFIGS[arch]
    return ResNet(block, layers, num_classes, stem).to(device)


def resnet18(num_classes: int = 10, stem: str = "cifar",
             device=None) -> ResNet:
    """Default mirrors the reference's CIFAR/GTSRB variant."""
    return resnet("resnet18", num_classes, stem, device)


def resnet50(num_classes: int = 1000, stem: str = "imagenet",
             device=None) -> ResNet:
    return resnet("resnet50", num_classes, stem, device)
