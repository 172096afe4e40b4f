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
``[depth, ...]``, and its probe is one ``[depth, ...preact]`` zero tensor,
made at depth 0 and added slice by slice, so ``autograd.grad`` returns
``[depth, ...preact]``, JAX's layout (its probes are a scanned input).
"""
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

    @property
    def mat_cols(self) -> int:
        return self.fan_in + (1 if self.has_bias else 0)


class Context:
    """Per-forward capture state, passed down the model as ``ctx``.

    ``track`` names the layers to capture. ``update_stats`` says whether
    BatchNorm layers in train mode update their running statistics; the
    estimator's capture leaves them alone, as the JAX ``collect`` discards
    the new statistics. ``probes=False`` records the inputs only (a
    capture that needs no output gradients adds no probe).
    """

    def __init__(self, track: Iterable[str] = (), update_stats: bool = False,
                 probes: bool = True):
        self.track = frozenset(track)
        self.update_stats = update_stats
        self.make_probes = probes
        self.acts: Dict[str, torch.Tensor] = {}
        self.probes: Dict[str, torch.Tensor] = {}
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

    def stack_acts(self):
        """Stack the per-depth inputs of a ScanBlocks run: [depth, ...]."""
        for name, v in self.acts.items():
            if isinstance(v, list):
                self.acts[name] = torch.stack(v)

    def probe(self, name: str, y: torch.Tensor) -> torch.Tensor:
        if name not in self.track or not self.make_probes:
            return y
        if self.scan is not None:
            i, depth = self.scan
            if i == 0:
                self.probes[name] = y.new_zeros((depth,) + y.shape,
                                                requires_grad=True)
            return y + self.probes[name][i]
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
    a stacked layer's [depth, ...] weight -> [depth, out, fan_in(+1)]."""
    lead = (meta.stacked,) if meta.stacked else ()
    mat = weight.reshape(lead + (meta.out_features, -1))
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
