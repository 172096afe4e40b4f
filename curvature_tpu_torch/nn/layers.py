"""Layers of the ResNet slice: tracked ``Dense``/``Conv`` and the untracked
``BatchNorm``, ``ReLU``, ``MaxPool`` and ``GlobalAvgPool``.

Port of the matching subset of ``curvature_tpu/nn/layers.py`` in PyTorch
layout (NCHW activations, OIHW conv weights, [out, in] dense weights).
Tracked layers take the capture context ``ctx`` (nn/core.py) and record
their input and probe their pre-activation output.
"""
import math
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from curvature_tpu_torch.nn.core import Context, LayerMeta
from curvature_tpu_torch.ops.patches import resolve_padding


def normalize_padding(padding, kernel_size: Tuple[int, int]):
    """int / (int, int) / 'SAME' / 'VALID' / explicit pairs -> the JAX
    padding form (``((pt, pb), (pl, pr))`` or the string)."""
    if isinstance(padding, str):
        return padding
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    if isinstance(padding, (tuple, list)):
        if all(isinstance(p, int) for p in padding):
            return tuple((p, p) for p in padding)
        return tuple(tuple(p) for p in padding)
    raise ValueError(f"bad padding: {padding!r}")


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Dense(nn.Module):
    """Tracked fully-connected layer (torch ``Linear`` weights)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, name: Optional[str] = None):
        super().__init__()
        self.name = name
        bound = 1.0 / math.sqrt(max(in_features, 1))
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(-bound, bound))
        self.bias = (nn.Parameter(torch.empty(out_features)
                                  .uniform_(-bound, bound))
                     if bias else None)

    @property
    def meta(self) -> LayerMeta:
        out_f, in_f = self.weight.shape
        return LayerMeta(self.name, "dense", out_f, in_f,
                         self.bias is not None)

    def forward(self, x, ctx: Optional[Context] = None):
        if ctx is not None:
            ctx.record_act(self.name, x)
        y = F.linear(x, self.weight, self.bias)
        return ctx.probe(self.name, y) if ctx is not None else y


class Conv(nn.Module):
    """Tracked 2D convolution, groups=1, with the JAX padding forms.

    Explicit symmetric padding goes to ``F.conv2d`` directly; asymmetric
    pads (XLA's stride-aware 'SAME' gives the high side the extra row)
    go through ``F.pad`` first, never torch's ``padding='same'``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Any = "VALID", bias: bool = True,
                 name: Optional[str] = None):
        super().__init__()
        self.name = name
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = normalize_padding(padding, self.kernel_size)
        kh, kw = self.kernel_size
        fan_in = in_channels * kh * kw
        bound = 1.0 / math.sqrt(max(fan_in, 1))
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kh, kw)
            .uniform_(-bound, bound))
        self.bias = (nn.Parameter(torch.empty(out_channels)
                                  .uniform_(-bound, bound))
                     if bias else None)

    @property
    def meta(self) -> LayerMeta:
        o, c, kh, kw = self.weight.shape
        return LayerMeta(self.name, "conv", o, c * kh * kw,
                         self.bias is not None, self.kernel_size,
                         self.stride, self.padding)

    def forward(self, x, ctx: Optional[Context] = None):
        if ctx is not None:
            # the JAX layout (NHWC) for the A-factor paths; a view, and a
            # contiguous one when the model runs in channels_last
            ctx.record_act(self.name, x.permute(0, 2, 3, 1))
        (pt, pb), (pl, pr) = resolve_padding(
            self.padding, x.shape[2], x.shape[3], self.kernel_size,
            self.stride)
        if pt == pb and pl == pr:
            y = F.conv2d(x, self.weight, self.bias, self.stride, (pt, pl))
        else:
            y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), self.weight, self.bias,
                         self.stride)
        return ctx.probe(self.name, y) if ctx is not None else y


class BatchNorm(nn.Module):
    """Torch-semantics batch normalization over NCHW channels, in f32.

    Train mode normalizes with batch statistics (biased variance) and
    updates the running statistics with momentum 0.1 and the unbiased
    variance; eval mode uses the running statistics. Under an estimator's
    capture context (``ctx.update_stats`` False) train mode leaves the
    running statistics untouched.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, ctx: Optional[Context] = None):
        update = ctx is None or ctx.update_stats
        keep = self.training and not update
        out = F.batch_norm(
            x.float(),
            None if keep else self.running_mean,
            None if keep else self.running_var,
            self.weight.float(), self.bias.float(),
            training=self.training, momentum=self.momentum, eps=self.eps)
        return out.to(x.dtype)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class MaxPool(nn.Module):
    """Max pooling; the padding is -inf (torch's implicit pad)."""

    def __init__(self, kernel_size: int, stride: Optional[int] = None,
                 padding: int = 0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class GlobalAvgPool(nn.Module):
    def forward(self, x):
        return x.mean(dim=(2, 3))
