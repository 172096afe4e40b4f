"""Layer metadata, the capture context, and the estimators' matrix view.

Port of ``curvature_tpu/nn/core.py``. The capture contract is the same as
the JAX ``Context.record_act``/``probe``:

  * every tracked layer (``Conv``/``Dense``) records its input;
  * every tracked layer adds a zero *probe* tensor to its pre-activation
    output ``y``, so the gradient of the loss with respect to the probe is
    dL/dy. One forward builds the graph; each Monte-Carlo label draw is one
    ``torch.autograd.grad`` over all probes at once.

Layer identity is the torchvision state-dict path (``"layer1.0.conv2"``),
the same string as the JAX ``LayerMeta.name``.

A layer inside a depth-stacked :class:`~curvature_tpu_torch.nn.scan.
ScanBlocks` runs once per depth under one name. While ScanBlocks loops, the
context knows the depth (``scan``): the layer's inputs come back stacked
``[depth, ...]``, and its probes are a list of ``depth`` leaves, one of
the per-depth shape ``[...preact]`` each, a zero scalar expanded (no
fill). ``collect`` writes each depth's gradient once into its slot of
one ``[S, depth, ...preact]`` tensor, JAX's layout (its probes are a
scanned input). One ``[depth, ...]`` leaf indexed per depth would make
every depth's backward a zero ``[depth, ...]`` tensor and autograd add
``depth`` of them: work that grows as depth².

A layer named in the context's ``gram_taps`` gets a :class:`GramTap`
instead of a probe (JAX ``gram_tap``, core.py:66-96): the identity on
``y``, whose backward hands the float32 ``[out, out]`` token Gram of the
output gradient to a zero accumulator input, so ``autograd.grad`` over
the accumulator returns the Gram that KFAC's G factor needs and the full
output gradient is never returned.

An MoE's expert layers run over their routed rows only (nn/layers.py
``MoE``): such a layer records the ``[rows, in]`` stream of the tokens
routed to the experts it holds, sorted by expert, and its
:class:`Routes` (``record_routes``), and probes its ``[rows, out]``
output. :meth:`Routes.dense` rebuilds the masked per-expert stream
``[held, *tokens, F]`` (zero rows for the tokens routed elsewhere) from
such rows by an exact scatter.
"""
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import torch


@dataclass(frozen=True)
class LayerMeta:
    """Static description of a tracked layer.

    ``fan_in`` counts input features (Dense) or C*kh*kw (Conv), the row
    dimension of the A factor before the bias row is appended. ``stacked``
    > 0 marks a layer of a ScanBlocks stack: its parameters, inputs, probes
    and factor state carry a leading ``[stacked]`` depth axis. ``groups``
    > 1 marks a grouped (or depthwise) conv: ``fan_in`` then counts the
    (C/groups)*kh*kw inputs each output channel sees, torch's ``[O,
    C/groups, kh, kw]`` weight. ``heads`` is the head count of an
    attention projection (0 elsewhere).
    """
    name: str
    kind: str                       # 'dense' | 'conv'
    out_features: int
    fan_in: int
    has_bias: bool
    kernel_size: Tuple[int, int] = ()
    strides: Tuple[int, int] = ()
    padding: Any = "VALID"
    stacked: int = 0
    groups: int = 1
    heads: int = 0
    moe: bool = False

    @property
    def mat_cols(self) -> int:
        return self.fan_in + (1 if self.has_bias else 0)


@dataclass(frozen=True)
class Routes:
    """Where the rows of a routed expert stream come from: rows
    ``offsets[e]:offsets[e + 1]`` belong to held expert ``e``, and row ``i``
    is token ``tokens[i]`` of the ``prod(lead)`` flattened tokens of the
    layer's input (``lead``: its token shape, ``[B, T]`` or ``[B]``)."""
    offsets: Tuple[int, ...]
    tokens: torch.Tensor
    lead: Tuple[int, ...]

    @property
    def experts(self) -> int:
        return len(self.offsets) - 1

    @property
    def rows(self) -> int:
        return self.offsets[-1]

    @property
    def num_tokens(self) -> int:
        return math.prod(self.lead)

    def dense(self, rows: torch.Tensor) -> torch.Tensor:
        """``[*pre, rows, F]`` routed rows -> the masked stream ``[*pre,
        held, *lead, F]``: each row at its (expert, token), zeros
        elsewhere. A copy of every value, so exact."""
        pre, f = rows.shape[:-2], rows.shape[-1]
        counts = torch.tensor(
            [b - a for a, b in zip(self.offsets, self.offsets[1:])],
            device=rows.device)
        expert = torch.repeat_interleave(
            torch.arange(self.experts, device=rows.device), counts)
        n = self.num_tokens
        out = rows.new_zeros(pre + (self.experts * n, f))
        out.index_copy_(len(pre), expert * n + self.tokens, rows)
        return out.reshape(pre + (self.experts,) + self.lead + (f,))


class GramTap(torch.autograd.Function):
    """``GramTap.apply(y, acc, dim)``: the identity on ``y``; the gradient
    that reaches ``acc`` (a zero float32 ``[out, out]`` tensor that
    requires grad) is ``sum_n g_n g_n^T`` over every position of the output
    gradient ``g`` with its channel axis ``dim`` moved last (NCHW conv
    outputs: ``dim=1``). A bf16 gradient is upcast first: each product of
    two bf16 values is exact in f32, as JAX's
    ``preferred_element_type=f32``."""

    @staticmethod
    def forward(ctx, y, acc, dim):
        ctx.dim = dim
        return y.view_as(y)

    @staticmethod
    def backward(ctx, ct):
        g = ct.movedim(ctx.dim, -1)
        g = g.reshape(-1, g.shape[-1]).float()
        return ct, g.T @ g, None


class Context:
    """Per-forward capture state, passed down the model as ``ctx``.

    ``track`` names the layers to capture. ``update_stats`` says whether
    BatchNorm layers in train mode update their running statistics; the
    estimator's capture leaves them alone, as the JAX ``collect`` discards
    the new statistics. ``probes=False`` records the inputs only (a
    capture that needs no output gradients adds no probe).
    ``decompose_norm`` has train-mode BatchNorm compute its batch
    statistics from plain tensor ops (as JAX's layer does) instead of the
    fused kernel: the exact products and per-example gradients run under
    ``torch.func.vmap``, where cuDNN's batch-norm backward asks a batched
    tensor for its channels_last layout, which vmap does not answer.
    ``gram_taps`` maps the layers whose output gradient is reduced to its
    token Gram in the backward (:class:`GramTap`) to their channel axis;
    those get a zero ``[out, out]`` accumulator in ``taps`` (and their
    token count in ``tap_tokens``) instead of a probe. ``data_group`` is
    the process group of a batch split over ranks (a mesh's data axis):
    train-mode BatchNorm then normalizes with the statistics of the whole
    batch, as JAX's sharded program does (nn/layers.py). ``seq_group`` is
    the process group of a token dim split over ranks (a mesh's seq axis)
    and ``seq_offset`` the global position of this rank's first token: a
    causal attention then gathers every rank's keys and values and masks
    at global positions (models/gpt.py).
    """

    def __init__(self, track: Iterable[str] = (), update_stats: bool = False,
                 probes: bool = True, decompose_norm: bool = False,
                 gram_taps: Optional[Dict[str, int]] = None,
                 data_group=None, seq_group=None, seq_offset: int = 0):
        self.track = frozenset(track)
        self.data_group = data_group
        self.seq_group = seq_group
        self.seq_offset = seq_offset
        self.gram_taps = dict(gram_taps or {})
        self.taps: Dict[str, torch.Tensor] = {}
        self.tap_tokens: Dict[str, int] = {}
        self.update_stats = update_stats
        self.make_probes = probes
        self.decompose_norm = decompose_norm
        self.acts: Dict[str, torch.Tensor] = {}
        self.routes: Dict[str, Routes] = {}
        #: layer -> its probe leaf, or a stacked layer's per-depth leaves
        self.probes: Dict[str, Any] = {}
        #: (depth index, depth) while a ScanBlocks stack runs its template
        self.scan: Optional[Tuple[int, int]] = None

    def record_act(self, name: str, x: torch.Tensor):
        if name not in self.track:
            return
        if self.scan is None:
            self.acts[name] = x.detach()
        else:
            i, depth = self.scan
            self.acts.setdefault(name, [None] * depth)[i] = x.detach()

    def record_routes(self, name: str, routes: Routes):
        """The :class:`Routes` of a routed expert layer's recorded rows."""
        if name in self.track:
            self.routes[name] = routes

    def stack_acts(self):
        """Stack the per-depth inputs of a ScanBlocks run: [depth, ...]."""
        for name, v in self.acts.items():
            if isinstance(v, list):
                self.acts[name] = torch.stack(v)

    def probe(self, name: str, y: torch.Tensor) -> torch.Tensor:
        if name not in self.track or not self.make_probes:
            return y
        if name in self.gram_taps:
            if self.scan is not None:
                raise ValueError(f"{name}: a stacked layer cannot be "
                                 "gram-tapped")
            dim = self.gram_taps[name]
            out = y.shape[dim]
            acc = torch.zeros((out, out), dtype=torch.float32,
                              device=y.device, requires_grad=True)
            self.taps[name] = acc
            self.tap_tokens[name] = y.numel() // out
            return GramTap.apply(y, acc, dim)
        if self.scan is not None:
            i, depth = self.scan
            if i == 0:
                self.probes[name] = [None] * depth
            p = y.new_zeros(()).expand(y.shape).requires_grad_()
            self.probes[name][i] = p
            return y + p
        # zeros_like keeps y's memory format, so a channels_last model gets
        # channels_last probe gradients
        p = torch.zeros_like(y, requires_grad=True)
        self.probes[name] = p
        return y + p


def param_key(name: str, leaf: str) -> str:
    """The state-dict key of a tracked layer's ``leaf`` (``"weight"``,
    ``"bias"``): the layer name with an attention projection's ``/``
    (``"attn/in_proj"``, JAX's name) as the module path's ``.``."""
    return f"{name.replace('/', '.')}.{leaf}"


# ---------------------------------------------------------------------------
# Matrix views: estimators work on the [out, fan_in(+1)] weight matrix per
# tracked layer (the reference's ``grads.view(shape[0], -1)`` plus the bias
# column). OIHW flattens to (c, kh, kw) columns directly; a grouped conv's
# [O, C/g, kh, kw] weight to its per-group (C/g)*kh*kw columns, the output
# channels group-major (rows j*O/g .. (j+1)*O/g belong to group j), as
# JAX's view of its HWIO kernel (core.py:246-301).
# ---------------------------------------------------------------------------

def param_matrix(meta: LayerMeta, weight: torch.Tensor,
                 bias: torch.Tensor = None) -> torch.Tensor:
    """Layer weight (OIHW conv, [out, in] dense) -> [out, fan_in(+1)];
    a stacked layer's [depth, ...] weight -> [depth, out, fan_in(+1)]. The
    sizes come from the weight, so a rank's block of a split layer (nn/
    placement.py) gives its block of the matrix."""
    mat = weight.flatten(2 if meta.stacked else 1)
    if meta.has_bias:
        mat = torch.cat([mat, bias[..., None]], dim=-1)
    return mat


def matrix_to_delta(meta: LayerMeta, mat: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """[(depth,) out, fan_in(+1)] matrix -> ``{"weight": ..., "bias":
    ...}``."""
    out = {}
    if meta.has_bias:
        out["bias"] = mat[..., -1]
        mat = mat[..., :-1]
    if meta.kind == "conv":
        kh, kw = meta.kernel_size
        mat = mat.reshape(mat.shape[:-2] + (
            meta.out_features, meta.fan_in // (kh * kw), kh, kw))
    out["weight"] = mat
    return out


def apply_matrix_delta(metas: Dict[str, LayerMeta],
                       params: Dict[str, torch.Tensor],
                       deltas: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Add sampled [out, fan_in(+1)] offsets onto the MAP parameters.

    ``params`` maps state-dict keys (``"fc.weight"``) to tensors; the
    result is a new dict (the mean is never mutated), ready for
    ``torch.func.functional_call``.
    """
    new = dict(params)
    for name, mat in deltas.items():
        for key, val in matrix_to_delta(metas[name], mat).items():
            full = param_key(name, key)
            new[full] = new[full] + val.to(new[full].dtype)
    return new
