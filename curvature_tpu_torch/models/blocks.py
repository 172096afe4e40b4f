"""Pieces the convolutional families share: the :class:`ZooNet` base that
names every tracked layer by its torchvision state-dict path, the
conv-BN-activation unit, squeeze-excitation, and torchvision's channel
rounding.

A family's module tree follows torchvision's, so ``named_modules`` paths
are torchvision's state-dict paths and the JAX package's layer names
(``"features.1.0.block.0.0"``); :class:`~curvature_tpu_torch.nn.
Sequential` registers unnamed layers under their position, as torch's
``nn.Sequential`` does.
"""
from typing import Dict, Optional

import torch
from torch import nn

from curvature_tpu_torch.nn import (
    BatchNorm, Conv, CtxModule, Dense, LayerMeta, MultiheadAttention, ReLU,
    Sequential)


def make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding (JAX mobilenet.py ``_make_divisible``):
    the nearest multiple of ``divisor``, never below 90% of ``v``."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ZooNet(CtxModule):
    """Base of a model: :meth:`name_layers`, called at the end of the
    constructor, names each tracked layer by its module path (an
    attention's projections ``<path>/in_proj`` and ``<path>/out_proj``,
    JAX's names), and ``metas`` lists the tracked layers in forward order
    (registration order, which every family keeps)."""

    def name_layers(self):
        for name, m in self.named_modules():
            if isinstance(m, (Conv, Dense)):
                m.name = name
        for name, m in self.named_modules():
            if isinstance(m, MultiheadAttention):
                m.set_name(name)

    @property
    def metas(self) -> Dict[str, LayerMeta]:
        return {m.name: m.meta for m in self.modules()
                if isinstance(m, (Conv, Dense))}


def named(**layers) -> Sequential:
    """A :class:`~curvature_tpu_torch.nn.Sequential` of ``layers`` in
    keyword order, each registered under its keyword (torchvision's
    named children: DenseNet's ``norm0``/``conv0``, a transition's
    ``norm``/``conv``)."""
    seq = Sequential([])
    for key, layer in layers.items():
        seq.add_module(key, layer)
    return seq


def conv_bn(cin: int, cout: int, kernel_size: int, stride: int = 1,
            groups: int = 1, act: Optional[nn.Module] = None,
            eps: float = 1e-5) -> Sequential:
    """torchvision's ``Conv2dNormActivation``: a bias-free conv padded by
    (k-1)/2 at ``{name}.0``, BatchNorm at ``.1``, the activation (if any)
    at ``.2``."""
    layers = [Conv(cin, cout, kernel_size, stride,
                   padding=(kernel_size - 1) // 2, bias=False,
                   groups=groups),
              BatchNorm(cout, eps=eps)]
    return Sequential(layers + ([act] if act is not None else []))


class SqueezeExcitation(CtxModule):
    """torchvision's ``SqueezeExcitation``: the global mean, two tracked
    1x1 convs with bias (``fc1``, ``fc2``; their inputs are single-token
    [B, 1, 1, C] patches), an activation between them and a gate that
    scales the input. ``gate`` is sigmoid (EfficientNet, RegNet) or
    Hardsigmoid (MobileNetV3)."""

    def __init__(self, channels: int, squeeze: int,
                 act: Optional[nn.Module] = None,
                 gate: Optional[nn.Module] = None):
        super().__init__()
        self.fc1 = Conv(channels, squeeze, 1)
        self.fc2 = Conv(squeeze, channels, 1)
        self.act = act if act is not None else ReLU()
        self.gate = gate

    def forward(self, x, ctx=None):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(self.act(self.fc1(s, ctx)), ctx)
        s = torch.sigmoid(s) if self.gate is None else self.gate(s)
        return x * s
