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
"""
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Tuple

import torch


@dataclass(frozen=True)
class LayerMeta:
    """Static description of a tracked layer.

    ``fan_in`` counts input features (Dense) or C*kh*kw (Conv), the row
    dimension of the A factor before the bias row is appended.
    """
    name: str
    kind: str                       # 'dense' | 'conv'
    out_features: int
    fan_in: int
    has_bias: bool
    kernel_size: Tuple[int, int] = ()
    strides: Tuple[int, int] = ()
    padding: Any = "VALID"

    @property
    def mat_cols(self) -> int:
        return self.fan_in + (1 if self.has_bias else 0)


class Context:
    """Per-forward capture state, passed down the model as ``ctx``.

    ``track`` names the layers to capture. ``update_stats`` says whether
    BatchNorm layers in train mode update their running statistics; the
    estimator's capture leaves them alone, as the JAX ``collect`` discards
    the new statistics.
    """

    def __init__(self, track: Iterable[str] = (), update_stats: bool = False):
        self.track = frozenset(track)
        self.update_stats = update_stats
        self.acts: Dict[str, torch.Tensor] = {}
        self.probes: Dict[str, torch.Tensor] = {}

    def record_act(self, name: str, x: torch.Tensor):
        if name in self.track:
            self.acts[name] = x.detach()

    def probe(self, name: str, y: torch.Tensor) -> torch.Tensor:
        if name not in self.track:
            return y
        # zeros_like keeps y's memory format, so a channels_last model gets
        # channels_last probe gradients
        p = torch.zeros_like(y, requires_grad=True)
        self.probes[name] = p
        return y + p


# ---------------------------------------------------------------------------
# Matrix views: estimators work on the [out, fan_in(+1)] weight matrix per
# tracked layer (the reference's ``grads.view(shape[0], -1)`` plus the bias
# column). OIHW flattens to (c, kh, kw) columns directly.
# ---------------------------------------------------------------------------

def param_matrix(meta: LayerMeta, weight: torch.Tensor,
                 bias: torch.Tensor = None) -> torch.Tensor:
    """Layer weight (OIHW conv, [out, in] dense) -> [out, fan_in(+1)]."""
    mat = weight.reshape(meta.out_features, -1)
    if meta.has_bias:
        mat = torch.cat([mat, bias[:, None]], dim=1)
    return mat


def matrix_to_delta(meta: LayerMeta, mat: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """[out, fan_in(+1)] matrix -> ``{"weight": ..., "bias": ...}``."""
    out = {}
    if meta.has_bias:
        out["bias"] = mat[:, -1]
        mat = mat[:, :-1]
    if meta.kind == "conv":
        kh, kw = meta.kernel_size
        mat = mat.reshape(meta.out_features, meta.fan_in // (kh * kw), kh, kw)
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
            full = f"{name}.{key}"
            new[full] = new[full] + val.to(new[full].dtype)
    return new
