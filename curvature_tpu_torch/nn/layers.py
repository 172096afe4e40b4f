"""Layers of the ported model families: tracked ``Dense``/``Conv`` (grouped
and depthwise convs through ``groups``), the untracked ``BatchNorm``,
``LayerNorm`` (and ConvNeXt's ``ChannelLayerNorm`` on NCHW activations),
the activations ``ReLU``, ``ReLU6``, ``SiLU``, ``Hardsigmoid``,
``Hardswish``, ``GELU`` and ``Identity``, the pools ``MaxPool``,
``AvgPool``, ``AdaptiveAvgPool`` and ``GlobalAvgPool``, ``Flatten``, the
``Sequential`` and ``Add`` containers, ``MultiheadAttention`` (two
tracked ``Dense`` projections around an explicit softmax attention), and
the mixture-of-experts layer ``MoE`` (its experts a tracked
:class:`Experts` stack each).

Port of the matching subset of ``curvature_tpu/nn/layers.py`` in PyTorch
layout (NCHW activations, OIHW conv weights, [out, in] dense weights).
Tracked layers take the capture context ``ctx`` (nn/core.py) and record
their input and probe their pre-activation output.

Under a mesh (nn/placement.py) a ``Dense`` may hold its block of output
columns (``tensor`` axis) and an ``MoE``/``Experts`` its block of experts
(``expert`` axis); the forward then meets the other ranks' blocks in the
differentiable collectives of parallel/mesh.py, so every rank's output is
the whole layer's, and the metas keep the whole layer's shapes.
"""
import math
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from curvature_tpu_torch.nn.core import Context, LayerMeta
from curvature_tpu_torch.parallel.mesh import (
    all_reduce_sum, copy_to_group, gather_replicated, group_size,
    reduce_from_group)
from curvature_tpu_torch.ops.patches import resolve_padding


@dataclass(frozen=True)
class Split:
    """One mesh axis a module's parameters are split over: the axis name,
    its size, this rank's index on it, and its process group."""
    axis: str
    size: int
    index: int
    group: Any = field(default=None, compare=False)


def take_block(module: nn.Module, pname: str, dim: int, split: Split):
    """Replace ``module``'s parameter ``pname`` by this rank's block of it
    along ``dim``; the whole shape stays in ``module._full_shapes`` (the
    metas read it) and the split in ``module._splits``."""
    p = getattr(module, pname)
    full = module.__dict__.setdefault("_full_shapes", {})
    full.setdefault(pname, tuple(p.shape))
    module.__dict__.setdefault("_splits", {}).setdefault(pname, []).append(
        (dim, split))
    per = p.shape[dim] // split.size
    block = p.detach().narrow(dim, split.index * per, per).clone()
    setattr(module, pname, nn.Parameter(block, requires_grad=p.requires_grad))


def full_shape(module: nn.Module, pname: str) -> tuple:
    """The whole shape of a parameter, split or not."""
    return module.__dict__.get("_full_shapes", {}).get(
        pname, tuple(getattr(module, pname).shape))


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


class CtxModule(nn.Module):
    """A module whose forward takes the capture context ``ctx`` (the
    tracked layers, the containers, and the model blocks holding them);
    :class:`Sequential` and :class:`Add` pass it on to these only."""


class Dense(CtxModule):
    """Tracked fully-connected layer (torch ``Linear`` weights) over any
    leading batch/token dims. Inside a ScanBlocks stack its weight is
    ``[depth, out, in]`` and its meta is stacked. ``heads`` is stamped by
    an attention module on its projections (JAX gpt.py:69-73,
    layers.py:388-395).

    Column-parallel (``tp``, a :class:`Split` of the ``tensor`` axis; JAX
    ``_variable_shardings``): the layer holds its block of output features
    (weight rows, bias entries), computes its block of the output from the
    whole input, and the blocks meet in :func:`gather_replicated`, whose
    backward keeps this rank's block; the input passes
    :func:`copy_to_group`, whose backward sums the ranks' partial input
    gradients. The probe sits after the gather: every rank sees the whole
    output gradient."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, name: Optional[str] = None):
        super().__init__()
        self.name = name
        self.heads = 0
        self.tp: Optional[Split] = None
        bound = 1.0 / math.sqrt(max(in_features, 1))
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(-bound, bound))
        self.bias = (nn.Parameter(torch.empty(out_features)
                                  .uniform_(-bound, bound))
                     if bias else None)

    @property
    def meta(self) -> LayerMeta:
        shape = full_shape(self, "weight")
        out_f, in_f = shape[-2:]
        stacked = shape[0] if len(shape) == 3 else 0
        return LayerMeta(self.name, "dense", out_f, in_f,
                         self.bias is not None, stacked=stacked,
                         heads=self.heads)

    def shard_columns(self, split: Split):
        """Keep this rank's block of output features."""
        take_block(self, "weight", -2, split)
        if self.bias is not None:
            take_block(self, "bias", -1, split)
        self.tp = split

    def forward(self, x, ctx: Optional[Context] = None):
        if ctx is not None:
            ctx.record_act(self.name, x)
        if self.tp is None:
            y = F.linear(x, self.weight, self.bias)
        else:
            y = gather_replicated(
                F.linear(copy_to_group(x, self.tp.group), self.weight,
                         self.bias), self.tp.group, -1)
        return ctx.probe(self.name, y) if ctx is not None else y


class Experts(Dense):
    """The bias-free linear maps of ``num_experts`` experts, one weight
    ``[E, out, in]`` (the layout of a stacked ``Dense``), tracked as one
    layer whose meta is ``stacked=E, moe=True``. Its input is the
    mask-routed per-expert token stream ``[E, ..., in]``; it records that
    stream and probes its ``[E, ..., out]`` output, so every estimator's
    stacked factor math gives per-expert factors."""

    def __init__(self, num_experts: int, in_features: int,
                 out_features: int, name: Optional[str] = None):
        super().__init__(in_features, out_features, bias=False, name=name)
        bound = 1.0 / math.sqrt(max(in_features, 1))
        self.weight = nn.Parameter(torch.empty(
            num_experts, out_features, in_features).uniform_(-bound, bound))

    @property
    def meta(self) -> LayerMeta:
        return _experts_meta(self.name, full_shape(self, "weight"))

    def forward(self, xm, ctx: Optional[Context] = None):
        return _apply_experts(self.name, self.weight, xm, ctx)


def _experts_meta(name, shape) -> LayerMeta:
    e, out_f, in_f = shape
    return LayerMeta(name, "dense", out_f, in_f, False, stacked=e, moe=True)


def _apply_experts(name, weight, xm, ctx: Optional[Context]):
    """``y[e] = xm[e] @ weight[e]^T`` over a ``[E, ..., in]`` stream, with
    the capture of the tracked layer ``name``."""
    if ctx is not None:
        ctx.record_act(name, xm)
    e = xm.shape[0]
    y = (xm.reshape(e, -1, xm.shape[-1]) @ weight.mT.to(xm.dtype)
         ).reshape(xm.shape[:-1] + (weight.shape[-2],))
    return ctx.probe(name, y) if ctx is not None else y


class MoE(CtxModule):
    """Mixture-of-experts feed-forward layer with top-k routing
    (``top_k=1``: Switch Transformer, ``top_k=2``: GShard); JAX
    layers.py:401-494.

    The router is an untracked bias-free linear head (``router``, a
    ``torch.nn.Linear`` ``[E, in]``; JAX's ``<name>.router`` kernel
    ``[in, E]``) whose softmax ``p`` stays in the graph. Top-1 routing is
    the one-hot of ``argmax(p)``, top-k the sum of the one-hots of
    ``torch.topk``; ``gates = p * mask``. Dispatch is dense: the masked
    stream ``xm[e] = mask[..., e] * x`` (zeros for the tokens routed
    elsewhere) goes through every expert, so the layer pays E times the
    FFN's FLOPs, as JAX's does.

    With ``hidden`` each expert is the bias-free two-layer MLP ``act(x
    k1_e) k2_e`` (``fc1``, ``fc2``: :class:`Experts` named
    ``<name>.fc1``, ``<name>.fc2``), the mask re-applied after the
    activation so that ``act(0) != 0`` leaks no unrouted token into fc2's
    input; without it the layer itself is the single expert stack (its
    ``weight`` ``[E, features, in]``, its meta named ``<name>``). Each
    expert's A factor then sums over the tokens routed to it and divides
    by all N tokens, ``A_e = sum_{n routed to e} a_n a_n^T / N``: the
    Fisher block of expert e (unrouted tokens give zero gradient). The
    experts are bias-free by design, as in JAX.

    Expert-parallel (``ep``, a :class:`Split` of the ``expert`` axis; JAX
    ``_variable_shardings``): each rank holds its block of experts and
    runs them over every token (the dense dispatch); the router stays
    whole on every rank. The input passes :func:`copy_to_group` and the
    ranks' partial combines meet in :func:`reduce_from_group`, so the
    output and every gradient are the whole layer's. The capture then
    records this rank's experts' streams and probes, ``[E/size, ...]``.
    """

    def __init__(self, in_features: int, features: int, num_experts: int,
                 hidden: Optional[int] = None, activation=None,
                 top_k: int = 1, name: Optional[str] = None):
        super().__init__()
        if num_experts < 1:
            raise ValueError("MoE needs num_experts >= 1")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must lie in [1, {num_experts}]")
        self.features = features
        self.num_experts = num_experts
        self.hidden = hidden
        self.activation = activation or (
            lambda v: F.gelu(v, approximate="tanh"))
        self.top_k = top_k
        self.ep: Optional[Split] = None
        self.router = nn.Linear(in_features, num_experts, bias=False)
        if hidden is None:
            bound = 1.0 / math.sqrt(max(in_features, 1))
            self.weight = nn.Parameter(torch.empty(
                num_experts, features, in_features).uniform_(-bound, bound))
        else:
            self.fc1 = Experts(num_experts, in_features, hidden)
            self.fc2 = Experts(num_experts, hidden, features)
        self.name = None
        if name is not None:
            self.set_name(name)

    def set_name(self, name: str):
        self.name = name
        if self.hidden is not None:
            self.fc1.name = f"{name}.fc1"
            self.fc2.name = f"{name}.fc2"

    @property
    def meta(self) -> LayerMeta:
        """The single expert stack's meta (``hidden`` unset)."""
        return _experts_meta(self.name, full_shape(self, "weight"))

    def shard_experts(self, split: Split):
        """Keep this rank's block of experts."""
        if self.hidden is None:
            take_block(self, "weight", 0, split)
        else:
            for fc in (self.fc1, self.fc2):
                take_block(fc, "weight", 0, split)
        self.ep = split

    def route(self, x):
        """(router probabilities ``p``, the 0/1 routing mask), both
        ``[..., E]`` in ``x``'s dtype."""
        e = self.num_experts
        p = torch.softmax(x @ self.router.weight.mT.to(x.dtype), dim=-1)
        if self.top_k == 1:
            mask = F.one_hot(p.argmax(-1), e).to(x.dtype)
        else:
            idx = torch.topk(p, self.top_k, dim=-1).indices
            mask = F.one_hot(idx, e).sum(-2).to(x.dtype)
        return p, mask

    def forward(self, x, ctx: Optional[Context] = None):
        ep = self.ep
        if ep is not None:
            x = copy_to_group(x, ep.group)
        p, mask = self.route(x)
        gates = p * mask                                  # [..., E]
        if ep is not None:
            per = self.num_experts // ep.size
            gates = gates[..., ep.index * per:(ep.index + 1) * per]
            mask = mask[..., ep.index * per:(ep.index + 1) * per]
        mask_e = mask.movedim(-1, 0)[..., None]           # [E, ..., 1]
        xm = mask_e * x                                   # [E, ..., F]
        if self.hidden is None:
            ye = _apply_experts(self.name, self.weight, xm, ctx)
        else:
            h = self.activation(self.fc1(xm, ctx)) * mask_e
            ye = self.fc2(h, ctx)                         # [E, ..., O]
        out = (ye * gates.movedim(-1, 0)[..., None]).sum(0)
        return out if ep is None else reduce_from_group(out, ep.group)


def is_tracked(m: nn.Module) -> bool:
    """A tracked layer: ``Conv``, ``Dense`` (``Experts`` too), or a
    single-stack ``MoE``."""
    return isinstance(m, (Conv, Dense)) or (isinstance(m, MoE)
                                            and m.hidden is None)


class Conv(CtxModule):
    """Tracked 2D convolution with the JAX padding forms.

    ``groups > 1`` is a grouped convolution (``groups == in_channels``:
    depthwise): output channel block j sees input channel block j only, so
    the weight is ``[O, C/groups, kh, kw]`` and ``fan_in`` counts
    (C/groups)*kh*kw (JAX layers.py:73-129, with its divisibility errors,
    both raised here at construction). Explicit symmetric padding goes to
    ``F.conv2d`` directly; asymmetric pads (XLA's stride-aware 'SAME' gives
    the high side the extra row) go through ``F.pad`` first, never torch's
    ``padding='same'``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Any = "VALID", bias: bool = True,
                 groups: int = 1, name: Optional[str] = None):
        super().__init__()
        self.name = name
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = normalize_padding(padding, self.kernel_size)
        self.groups = int(groups)
        if self.groups < 1 or out_channels % self.groups:
            raise ValueError(
                f"groups={groups} must divide out features {out_channels}")
        if in_channels % self.groups:
            raise ValueError(
                f"{name}: groups={self.groups} must divide input channels "
                f"{in_channels}")
        kh, kw = self.kernel_size
        fan_in = in_channels // self.groups * kh * kw
        bound = 1.0 / math.sqrt(max(fan_in, 1))
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // self.groups, kh, kw)
            .uniform_(-bound, bound))
        self.bias = (nn.Parameter(torch.empty(out_channels)
                                  .uniform_(-bound, bound))
                     if bias else None)

    @property
    def meta(self) -> LayerMeta:
        o, c, kh, kw = self.weight.shape
        return LayerMeta(self.name, "conv", o, c * kh * kw,
                         self.bias is not None, self.kernel_size,
                         self.stride, self.padding, groups=self.groups)

    def forward(self, x, ctx: Optional[Context] = None):
        if ctx is not None:
            # the JAX layout (NHWC) for the A-factor paths; a view, and a
            # contiguous one when the model runs in channels_last
            ctx.record_act(self.name, x.permute(0, 2, 3, 1))
        (pt, pb), (pl, pr) = resolve_padding(
            self.padding, x.shape[2], x.shape[3], self.kernel_size,
            self.stride)
        if pt == pb and pl == pr:
            y = F.conv2d(x, self.weight, self.bias, self.stride, (pt, pl),
                         groups=self.groups)
        else:
            y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), self.weight, self.bias,
                         self.stride, groups=self.groups)
        return ctx.probe(self.name, y) if ctx is not None else y


class BatchNorm(CtxModule):
    """Torch-semantics batch normalization over NCHW channels, in f32.

    Train mode normalizes with batch statistics (biased variance) and
    updates the running statistics with momentum 0.1 and the unbiased
    variance; eval mode uses the running statistics. Under an estimator's
    capture context (``ctx.update_stats`` False) train mode leaves the
    running statistics untouched; it is a :class:`CtxModule`, so the
    containers hand it that context. The output takes the input's dtype; under
    an estimator's ``compute_dtype`` the scale and bias arrive rounded to
    it (JAX casts every float parameter, layers.py:154-171) while the
    running buffers stay f32.

    Under a context whose ``data_group`` spans more than one rank (the
    batch split over a mesh's data axis), train mode normalizes with the
    mean and biased variance of the whole batch: the decomposed formula
    with its two sums taken through a differentiable all-reduce, so the
    forward and the backward are those of the unsplit batch (JAX's
    sharded program). A train step's running statistics then update from
    those global statistics. A group of one rank, or none, keeps the
    fused kernel.
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
        group = ctx.data_group if ctx is not None else None
        if self.training and group_size(group) > 1:
            return self._decomposed(x, group, update)
        if keep and ctx.decompose_norm:
            return self._decomposed(x)
        out = F.batch_norm(
            x.float(),
            None if keep else self.running_mean,
            None if keep else self.running_var,
            self.weight.float(), self.bias.float(),
            training=self.training, momentum=self.momentum, eps=self.eps)
        return out.to(x.dtype)

    def _decomposed(self, x, group=None, update: bool = False):
        """Train-mode normalization by the batch's mean and biased variance
        over every axis but the channels, in plain tensor ops (the
        context's ``decompose_norm``). With ``group``, the batch split
        across its ranks (equal shards): the per-channel sums are
        all-reduced, and with ``update`` the running statistics take the
        global mean and unbiased variance."""
        xf = x.float()
        dims = [d for d in range(xf.ndim) if d != 1]
        shape = [1, -1] + [1] * (xf.ndim - 2)
        n = xf.numel() // xf.shape[1] * group_size(group)
        mean = all_reduce_sum(xf.sum(dims), group) / n
        centred = xf - mean.view(shape)
        var = all_reduce_sum((centred * centred).sum(dims), group) / n
        if update:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / (n - 1)))
        out = centred * torch.rsqrt(var + self.eps).view(shape) \
            * self.weight.float().view(shape) + self.bias.float().view(shape)
        return out.to(x.dtype)


class LayerNorm(nn.Module):
    """Layer normalization over the last dim, computed in f32 and returned
    in the input's dtype, with the JAX package's biased variance
    (``curvature_tpu/models/transformer2.py`` ``LayerNorm``; its ``scale``
    is torch's ``weight``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        out = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                           self.bias.float(), self.eps)
        return out.to(x.dtype)


class ChannelLayerNorm(LayerNorm):
    """:class:`LayerNorm` over the channel axis of NCHW activations
    (ConvNeXt's ``LayerNorm2d``; JAX normalizes NHWC's last axis)."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    """min(max(x, 0), 6): MobileNet's clipped activation."""

    def forward(self, x):
        return F.relu6(x)


class SiLU(nn.Module):
    """x * sigmoid(x): EfficientNet's activation."""

    def forward(self, x):
        return F.silu(x)


class Hardsigmoid(nn.Module):
    """relu6(x + 3) / 6: MobileNetV3's squeeze-excitation gate."""

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardswish(nn.Module):
    """x * relu6(x + 3) / 6: MobileNetV3's activation."""

    def forward(self, x):
        return F.hardswish(x)


class GELU(nn.Module):
    """The exact (erf) GELU, as JAX's ``approximate=False``."""

    def forward(self, x):
        return F.gelu(x)


class Identity(nn.Module):
    def forward(self, x):
        return x


class MaxPool(nn.Module):
    """Max pooling over a window, padded with -inf (JAX layers.py:174-209).

    ``padding`` takes JAX's forms: an int or pairs (explicit), ``"SAME"``
    (XLA's stride-aware split, GoogLeNet's pools) or ``"VALID"``.
    ``ceil_mode`` (explicit padding only; SqueezeNet's pools) rounds the
    output size up, the last window starting inside the input plus its low
    padding, by JAX's arithmetic: extra -inf rows on the high side. Pads
    that torch's implicit padding holds (symmetric, at most half the
    window) go to ``F.max_pool2d``; the others through an explicit -inf
    ``F.pad``."""

    def __init__(self, kernel_size, stride=None, padding: Any = 0,
                 ceil_mode: bool = False):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None \
            else self.kernel_size
        self.padding = normalize_padding(padding, self.kernel_size)
        if ceil_mode and isinstance(self.padding, str):
            raise ValueError("ceil_mode needs explicit (int) padding")
        self.ceil_mode = ceil_mode

    def pads(self, h: int, w: int):
        """((pt, pb), (pl, pr)) for an [.., h, w] input."""
        pads = [list(p) for p in resolve_padding(
            self.padding, h, w, self.kernel_size, self.stride)]
        if self.ceil_mode:
            for d, size in enumerate((h, w)):
                k, s = self.kernel_size[d], self.stride[d]
                lo, hi = pads[d]
                out = -(-(size + lo + hi - k) // s) + 1
                if (out - 1) * s >= size + lo:
                    out -= 1
                pads[d][1] = max(hi, (out - 1) * s + k - size - lo)
        return tuple(tuple(p) for p in pads)

    def forward(self, x):
        (pt, pb), (pl, pr) = self.pads(x.shape[-2], x.shape[-1])
        if pt == pb and pl == pr and 2 * pt <= self.kernel_size[0] \
                and 2 * pl <= self.kernel_size[1]:
            return F.max_pool2d(x, self.kernel_size, self.stride, (pt, pl))
        x = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
        return F.max_pool2d(x, self.kernel_size, self.stride)


class AvgPool(nn.Module):
    """Average pooling over a window; int padding is zero padding counted
    in the divisor (torch's ``count_include_pad=True``, as JAX divides by
    the full window, layers.py:211-230: Inception's ``AvgPool(3, 1, 1)``
    averages its border windows over 9)."""

    def __init__(self, kernel_size: int, stride: Optional[int] = None,
                 padding: int = 0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool(nn.Module):
    """torch's ``AdaptiveAvgPool2d`` bins, which the JAX layer unrolls."""

    def __init__(self, output_size: Union[int, Tuple[int, int]]):
        super().__init__()
        self.output_size = _pair(output_size)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class GlobalAvgPool(nn.Module):
    def forward(self, x):
        return x.mean(dim=(2, 3))


class Flatten(nn.Module):
    """[B, C, H, W] -> [B, C*H*W] in channel-major (c, h, w) order: NCHW's
    own order, which the JAX ``Flatten`` reaches by transposing NHWC first
    (layers.py:310-321), so a converted dense kernel lines up."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Sequential(CtxModule):
    """Layers applied in order, those that take it (the tracked
    ``Dense``/``Conv``, the containers and blocks: :class:`CtxModule`)
    with the capture context. A layer with a ``name`` is registered under
    it, so its state-dict keys and factor-file keys are the JAX layer names
    (``"conv1.weight"``, ``"fc1"``); the others under their position.
    ``metas`` lists the tracked layers in forward order."""

    def __init__(self, layers):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(getattr(layer, "name", None) or str(i), layer)

    @property
    def metas(self):
        return {m.name: m.meta for m in self.modules() if is_tracked(m)}

    def forward(self, x, ctx: Optional[Context] = None):
        for layer in self.children():
            x = layer(x, ctx) if isinstance(layer, CtxModule) else layer(x)
        return x


class Add(CtxModule):
    """Residual add of a main branch and a shortcut branch."""

    def __init__(self, main: nn.Module, shortcut: nn.Module):
        super().__init__()
        self.main = main
        self.shortcut = shortcut

    def forward(self, x, ctx: Optional[Context] = None):
        return sum(m(x, ctx) if isinstance(m, CtxModule) else m(x)
                   for m in (self.main, self.shortcut))


class MultiheadAttention(CtxModule):
    """Self-attention with torch's packed ``in_proj`` (q, k, v stacked
    along the outputs) and ``out_proj`` (JAX layers.py:353-398).

    Both projections are tracked :class:`Dense` layers whose meta names
    are ``<name>/in_proj`` and ``<name>/out_proj``, JAX's names (KFAC's
    qkv and head splits key on them), while their module paths, and so
    their state-dict keys, are ``<name>.in_proj`` and ``<name>.out_proj``
    (``nn.core.param_key`` maps one to the other). :meth:`set_name` names
    them; ``models.blocks.ZooNet.name_layers`` calls it with the module
    path. The head count is stamped on both. The attention is explicit,
    matmul, softmax in the input dtype, matmul, so ``torch.func.jvp`` and
    ``vmap`` run through it.
    """

    def __init__(self, embed_dim: int, num_heads: int,
                 name: Optional[str] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"num_heads {num_heads} must divide embed_dim "
                             f"{embed_dim}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj = Dense(embed_dim, 3 * embed_dim)
        self.out_proj = Dense(embed_dim, embed_dim)
        self.in_proj.heads = self.out_proj.heads = num_heads
        self.name = None
        if name is not None:
            self.set_name(name)

    def set_name(self, name: str):
        self.name = name
        self.in_proj.name = f"{name}/in_proj"
        self.out_proj.name = f"{name}/out_proj"

    def forward(self, x, ctx: Optional[Context] = None):
        b, t, e = x.shape
        h = self.num_heads
        d = e // h
        qkv = self.in_proj(x, ctx)                       # [B, T, 3E]
        q, k, v = (z.reshape(b, t, h, d).transpose(1, 2)
                   for z in qkv.split(e, dim=-1))        # [B, H, T, d]
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(d),
                             dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(b, t, e)
        return self.out_proj(o, ctx)
