"""What the reference records while a model runs: each matmul layer's
input and pre-activation output, and the multiply-adds of the matmuls
that are no layer (attention's QK^T and AV)."""
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Layer:
    """One matmul layer: a convolution (``kernel``, ``stride``,
    ``padding`` of an NCHW input) or a dense layer over the last axis.
    ``depth`` > 0 marks a layer of a stack of ``depth`` blocks, whose
    factors carry a leading ``[depth]`` axis."""
    name: str
    kind: str
    out: int
    fan_in: int
    bias: bool
    kernel: Tuple[int, int] = (1, 1)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    depth: int = 0

    @property
    def cols(self) -> int:
        """The A factor's side: the fan-in, and a ones column with a
        bias."""
        return self.fan_in + (1 if self.bias else 0)


class Recorder:
    """Collects, in forward order, every layer's (input, output) under its
    name (a stacked layer's per depth) and the multiply-adds of the
    matmuls that belong to no layer."""

    def __init__(self):
        self.inputs: Dict[str, List[torch.Tensor]] = {}
        self.outputs: Dict[str, List[torch.Tensor]] = {}
        self.extra_macs = 0

    def layer(self, name: str, x: torch.Tensor, y: torch.Tensor):
        self.inputs.setdefault(name, []).append(x)
        self.outputs.setdefault(name, []).append(y)

    def macs(self, n: int):
        self.extra_macs += int(n)


def conv(rec: Optional[Recorder], layer: Layer, x, weight, bias=None):
    y = F.conv2d(x, weight, bias, layer.stride, layer.padding)
    if rec is not None:
        rec.layer(layer.name, x, y)
    return y


def dense(rec: Optional[Recorder], name: str, x, weight, bias=None):
    y = F.linear(x, weight, bias)
    if rec is not None:
        rec.layer(name, x, y)
    return y
