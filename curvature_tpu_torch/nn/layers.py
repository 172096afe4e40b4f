"""Layers of the ported model families: tracked ``Dense``/``Conv`` (grouped
and depthwise convs through ``groups``), the untracked ``BatchNorm``,
``LayerNorm`` (and ConvNeXt's ``ChannelLayerNorm`` on NCHW activations),
``RMSNorm`` and DeepSeek's interleaved rotary embedding,
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

from curvature_tpu_torch.nn.core import Context, LayerMeta, Routes
from curvature_tpu_torch.parallel.mesh import (
    all_reduce_sum, copy_to_group, gather_replicated, group_size,
    reduce_from_group)
from curvature_tpu_torch.ops.patches import resolve_padding
from curvature_tpu_torch.utils import monitor


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
    """The bias-free linear maps of the experts an MoE holds, one weight
    ``[held, out, in]`` (the layout of a stacked ``Dense``), tracked as one
    layer whose meta is ``stacked=held, moe=True``. Its input is the routed
    stream ``[rows, in]`` (the tokens routed to the held experts, sorted by
    expert) with its :class:`~curvature_tpu_torch.nn.core.Routes`; each
    expert runs over its own rows only. It records that stream and its
    routes and probes its ``[rows, out]`` output, so each expert's factors
    sum over its routed tokens (nn/core.py)."""

    def __init__(self, num_experts: int, in_features: int,
                 out_features: int, name: Optional[str] = None):
        super().__init__(in_features, out_features, bias=False, name=name)
        bound = 1.0 / math.sqrt(max(in_features, 1))
        self.weight = nn.Parameter(torch.empty(
            num_experts, out_features, in_features).uniform_(-bound, bound))

    @property
    def meta(self) -> LayerMeta:
        return _experts_meta(self.name, full_shape(self, "weight"))

    def forward(self, xs, routes: Routes, ctx: Optional[Context] = None):
        return _apply_experts(self.name, self.weight, xs, routes, ctx)


def _experts_meta(name, shape) -> LayerMeta:
    e, out_f, in_f = shape
    return LayerMeta(name, "dense", out_f, in_f, False, stacked=e, moe=True)


def _apply_experts(name, weight, xs, routes: Routes,
                   ctx: Optional[Context]):
    """``y[rows of e] = xs[rows of e] @ weight[e]^T`` over a routed ``[rows,
    in]`` stream, with the capture of the tracked layer ``name``."""
    if ctx is not None:
        ctx.record_act(name, xs)
        ctx.record_routes(name, routes)
    w = weight.to(xs.dtype)
    o = routes.offsets
    y = torch.cat([xs[o[e]:o[e + 1]] @ w[e].mT
                   for e in range(routes.experts)])
    return ctx.probe(name, y) if ctx is not None else y


class MoE(CtxModule):
    """Mixture-of-experts feed-forward layer with top-k routing
    (``top_k=1``: Switch Transformer, ``top_k=2``: GShard; JAX
    layers.py:401-494) or DeepSeek-V3's sigmoid routing.

    The router is an untracked bias-free linear head (``router``, a
    ``torch.nn.Linear`` ``[E, in]``; JAX's ``<name>.router`` kernel
    ``[in, E]``) whose scores stay in the graph. ``scoring="softmax"``:
    ``p = softmax(logits)``, top-1 the ``argmax(p)``, top-k ``torch.topk``,
    each chosen expert weighted by its ``p``. ``scoring="sigmoid"``
    (DeepSeek-V3): ``s = sigmoid(logits)``; the chosen set is the top-k of
    ``s + e_score_correction_bias`` (an untracked buffer that decides the
    selection only), each chosen expert weighted by its ``s``, divided by
    the chosen scores' sum where ``norm_topk_prob``, times
    ``routed_scale``.

    Dispatch is routed: the (token, choice) pairs are sorted by expert,
    the experts the layer holds run over their own rows only, and each
    token's weighted outputs are summed back in the order of its choices
    (a scatter to distinct slots and a sum, so the output is the same on
    every run: the next layer's routing never sees an atomic add's
    order). One synchronize a forward reads the experts' row counts.

    With ``hidden`` each expert is the bias-free two-layer MLP ``act(x
    k1_e) k2_e`` (``fc1``, ``fc2``: :class:`Experts` named
    ``<name>.fc1``, ``<name>.fc2``), or with ``gated`` the SwiGLU
    ``(silu(x g_e) * (x u_e)) d_e`` (``gate_proj``, ``up_proj``,
    ``down_proj``); without ``hidden`` the layer itself is the single
    expert stack (its ``weight`` ``[E, features, in]``, its meta named
    ``<name>``). Each expert's A factor then sums over the tokens routed to
    it and divides by all N tokens, ``A_e = sum_{n routed to e} a_n a_n^T
    / N``: the Fisher block of expert e (unrouted tokens give zero
    gradient). The experts are bias-free by design, as in JAX.

    The held block: ``held=(start, count)`` keeps experts ``start ..
    start + count - 1`` (their weights ``[count, ...]``) while the router
    scores all ``num_experts``; the output is those experts' part of the
    layer's, on one process (a card of an expert-parallel host).
    Expert-parallel (``ep``, a :class:`Split` of the ``expert`` axis; JAX
    ``_variable_shardings``): each rank holds its block of experts in the
    same way; the input passes :func:`copy_to_group` and the ranks'
    partial combines meet in :func:`reduce_from_group`, so the output and
    every gradient are the whole layer's. The capture records the held
    experts' routed rows and probes.

    Inside each forward the spans ``moe.route``, ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine`` (utils/monitor.py) carry the
    ``layer``, the ``held`` experts and their routed ``rows``; dispatch and
    combine time the device. ``MoE.routed_rows`` counts the rows dispatched
    to held experts, ``MoE.dropped_tokens`` the (token, choice) pairs left
    out: 0, as no expert has a capacity.
    """

    #: rows dispatched to held experts, over every forward
    routed_rows = 0
    #: (token, choice) pairs no expert took; none (no capacity)
    dropped_tokens = 0

    def __init__(self, in_features: int, features: int, num_experts: int,
                 hidden: Optional[int] = None, activation=None,
                 top_k: int = 1, name: Optional[str] = None,
                 scoring: str = "softmax", gated: bool = False,
                 norm_topk_prob: bool = False, routed_scale: float = 1.0,
                 held: Optional[Tuple[int, int]] = None):
        super().__init__()
        if num_experts < 1:
            raise ValueError("MoE needs num_experts >= 1")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must lie in [1, {num_experts}]")
        if scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown scoring {scoring!r}: 'softmax' or "
                             "'sigmoid'")
        if gated and hidden is None:
            raise ValueError("gated experts need hidden")
        start, count = held if held is not None else (0, num_experts)
        if not (0 <= start and 1 <= count and start + count <= num_experts):
            raise ValueError(f"held={held} must lie in [0, {num_experts})")
        self.features = features
        self.num_experts = num_experts
        self.hidden = hidden
        self.gated = gated
        self.activation = activation or (
            F.silu if gated else (lambda v: F.gelu(v, approximate="tanh")))
        self.top_k = top_k
        self.scoring = scoring
        self.norm_topk_prob = norm_topk_prob
        self.routed_scale = routed_scale
        self.held = (start, count)
        self.ep: Optional[Split] = None
        self.router = nn.Linear(in_features, num_experts, bias=False)
        if scoring == "sigmoid":
            self.register_buffer("e_score_correction_bias",
                                 torch.zeros(num_experts))
        if hidden is None:
            bound = 1.0 / math.sqrt(max(in_features, 1))
            self.weight = nn.Parameter(torch.empty(
                count, features, in_features).uniform_(-bound, bound))
        elif gated:
            self.gate_proj = Experts(count, in_features, hidden)
            self.up_proj = Experts(count, in_features, hidden)
            self.down_proj = Experts(count, hidden, features)
        else:
            self.fc1 = Experts(count, in_features, hidden)
            self.fc2 = Experts(count, hidden, features)
        self.name = None
        if name is not None:
            self.set_name(name)

    def _expert_layers(self):
        if self.hidden is None:
            return {}
        if self.gated:
            return {"gate_proj": self.gate_proj, "up_proj": self.up_proj,
                    "down_proj": self.down_proj}
        return {"fc1": self.fc1, "fc2": self.fc2}

    def set_name(self, name: str):
        self.name = name
        for leaf, layer in self._expert_layers().items():
            layer.name = f"{name}.{leaf}"

    @property
    def meta(self) -> LayerMeta:
        """The single expert stack's meta (``hidden`` unset)."""
        return _experts_meta(self.name, full_shape(self, "weight"))

    def shard_experts(self, split: Split):
        """Keep this rank's block of experts."""
        if self.held != (0, self.num_experts):
            raise ValueError(f"{self.name}: a layer that holds a block of "
                             "experts cannot be split again")
        if self.hidden is None:
            take_block(self, "weight", 0, split)
        else:
            for fc in self._expert_layers().values():
                take_block(fc, "weight", 0, split)
        per = self.num_experts // split.size
        self.held = (split.index * per, per)
        self.ep = split

    def select(self, x2):
        """(chosen experts ``[N, k]``, their combine weights ``[N, k]`` in
        ``x2``'s dtype) of the tokens ``x2`` ``[N, in]``."""
        logits = x2 @ self.router.weight.mT.to(x2.dtype)
        if self.scoring == "softmax":
            p = torch.softmax(logits, dim=-1)
            idx = (p.argmax(-1, keepdim=True) if self.top_k == 1
                   else torch.topk(p, self.top_k, dim=-1).indices)
            return idx, p.gather(-1, idx)
        s = torch.sigmoid(logits)
        choice = s.detach() + self.e_score_correction_bias.to(s.dtype)
        idx = torch.topk(choice, self.top_k, dim=-1).indices
        w = s.gather(-1, idx)
        if self.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * self.routed_scale

    def route(self, x):
        """(router scores, the 0/1 routing mask), both ``[..., E]`` in
        ``x``'s dtype: the softmax ``p`` or the sigmoid ``s``."""
        e = self.num_experts
        x2 = x.reshape(-1, x.shape[-1])
        logits = x2 @ self.router.weight.mT.to(x.dtype)
        scores = (torch.softmax(logits, dim=-1) if self.scoring == "softmax"
                  else torch.sigmoid(logits))
        idx, _ = self.select(x2)
        mask = F.one_hot(idx, e).sum(-2).to(x.dtype)
        return (scores.reshape(x.shape[:-1] + (e,)),
                mask.reshape(x.shape[:-1] + (e,)))

    def _experts(self, xs, routes: Routes, ctx: Optional[Context]):
        if self.hidden is None:
            return _apply_experts(self.name, self.weight, xs, routes, ctx)
        if self.gated:
            h = self.activation(self.gate_proj(xs, routes, ctx)) \
                * self.up_proj(xs, routes, ctx)
            return self.down_proj(h, routes, ctx)
        return self.fc2(self.activation(self.fc1(xs, routes, ctx)), routes,
                        ctx)

    def forward(self, x, ctx: Optional[Context] = None):
        ep = self.ep
        if ep is not None:
            x = copy_to_group(x, ep.group)
        lead, k = tuple(x.shape[:-1]), self.top_k
        x2 = x.reshape(-1, x.shape[-1])
        n = x2.shape[0]
        start, count = self.held
        with monitor.span("moe.route", layer=self.name, held=count):
            idx, w = self.select(x2)                          # [N, k]
        with monitor.span("moe.dispatch", x.device, layer=self.name,
                          held=count) as sp:
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)
            counts = torch.bincount(flat, minlength=self.num_experts)
            counts = counts.tolist()
            lo = sum(counts[:start])
            offsets = [0]
            for c in counts[start:start + count]:
                offsets.append(offsets[-1] + c)
            rows = offsets[-1]
            slots = order[lo:lo + rows]         # the (token, choice) pairs
            tok = torch.div(slots, k, rounding_mode="floor")
            xs = x2[tok]                                      # [rows, in]
            if sp is not None:
                sp.attrs["rows"] = rows
        MoE.routed_rows += rows
        MoE.dropped_tokens += n * k - sum(counts)
        with monitor.span("moe.experts", layer=self.name, held=count,
                          rows=rows):
            ys = self._experts(xs, Routes(tuple(offsets), tok, lead), ctx)
        with monitor.span("moe.combine", x.device, layer=self.name,
                          held=count, rows=rows):
            gate = w.reshape(-1)[slots]
            weighted = ys * gate[:, None]
            out = weighted.new_zeros(n * k, weighted.shape[-1]).index_copy(
                0, slots, weighted).reshape(n, k, -1).sum(1)
        out = out.reshape(lead + (out.shape[-1],))
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


class RMSNorm(nn.Module):
    """Root-mean-square normalization over the last dim (Zhang and
    Sennrich, 2019; Hugging Face's ``LlamaRMSNorm``): ``weight * x /
    sqrt(mean(x^2) + eps)``, the mean in f32, the product in the input's
    dtype."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x):
        v = x.float()
        v = v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * v.to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float,
                 dtype=torch.float32):
    """(cos, sin) ``[T, dim]`` of the rotary embedding (Su et al., 2021) at
    integer ``positions``: frequencies ``theta^(-2i/dim)``, each angle
    twice, the two halves ``rotate_half`` pairs."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim)
    ang = positions.float()[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope_interleaved(x, cos, sin):
    """DeepSeek's RoPE on ``[..., T, d]``: the interleaved pairs ``(x0,
    x1), (x2, x3), ...`` first laid out as two halves (``view(..., d/2,
    2).transpose(-1, -2)``), then ``x cos + rotate_half(x) sin``."""
    d = x.shape[-1]
    x = x.reshape(x.shape[:-1] + (d // 2, 2)).transpose(-1, -2).reshape(
        x.shape)
    return x * cos + rotate_half(x) * sin


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
