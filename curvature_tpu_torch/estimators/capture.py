"""Activation and output-gradient capture: one forward, S backwards.

Port of ``curvature_tpu/estimators/capture.py`` (classification only).
One forward under a capture :class:`~curvature_tpu_torch.nn.Context`
records every tracked layer's input and adds a zero probe to its
pre-activation output. Each Monte-Carlo label draw only changes the loss
cotangent at the logits, ``(softmax(logits) - onehot(labels_s)) / B``, so
the S backwards are a loop of ``torch.autograd.grad`` over the probes with
``retain_graph`` (chosen over ``is_grads_batched``, whose vmapped backward
does not cover every op's derivative, e.g. cuDNN batch norm).

Under a compute dtype the caller passes a cast parameter dict (``params``,
applied with ``torch.func.functional_call``) and a cast input; logits,
softmax, one-hot and cotangent then stay in the logits' dtype, as in JAX
(capture.py:74-83). MC labels are drawn from the softmax in f32.
"""
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from curvature_tpu_torch.nn.core import Context, LayerMeta


@dataclass
class Captured:
    """Per-batch capture results.

    acts:        layer -> input, JAX layout (NHWC conv, [B, in] dense).
    probe_grads: layer -> [S, ...preact] dL/dy of the mean loss, JAX
                 layout (NHWC conv, [S, B, out] dense).
    logits:      [B, K] outputs of the forward.
    batch_size:  B.
    """
    acts: Dict[str, torch.Tensor]
    probe_grads: Dict[str, torch.Tensor]
    logits: torch.Tensor
    batch_size: int


def sample_labels(logits: torch.Tensor, num_samples: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Categorical draws [S, B] from the model's output distribution (the
    'true' Fisher)."""
    probs = torch.softmax(logits.detach().float(), dim=-1)
    return torch.multinomial(probs, num_samples, replacement=True,
                             generator=generator).T


def ce_cotangent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """d(mean CE)/d logits = (softmax - onehot) / B, per label row:
    logits [B, K], labels [S, B] -> [S, B, K]."""
    p = torch.softmax(logits.detach(), dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(p.dtype)
    return (p[None] - onehot) / logits.shape[0]


def collect(model, metas: Dict[str, LayerMeta], x: torch.Tensor,
            labels: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            num_samples: int = 1,
            params: Optional[Dict[str, torch.Tensor]] = None) -> Captured:
    """Capture acts and probe gradients for the layers in ``metas``.

    ``labels`` are [S, B] (or [B]) class labels; ``None`` draws
    ``num_samples`` labels from the model distribution with
    ``generator``. ``params`` (state-dict keys) replace the model's own
    parameters for this forward; the model is not changed. The model runs
    in train mode (batch-statistics BN) and its running statistics are
    left untouched.
    """
    was_training = model.training
    model.train()
    ctx = Context(track=metas)
    try:
        logits = (model(x, ctx) if params is None
                  else functional_call(model, params, (x, ctx)))
    finally:
        model.train(was_training)
    if labels is None:
        labels = sample_labels(logits, num_samples, generator)
    labels = torch.as_tensor(labels, device=logits.device)
    if labels.ndim == 1:
        labels = labels[None]
    cots = ce_cotangent(logits, labels)
    names = list(metas)
    probes = [ctx.probes[n] for n in names]
    grads = {n: [] for n in names}
    for s in range(cots.shape[0]):
        gs = torch.autograd.grad(logits, probes, grad_outputs=cots[s],
                                 retain_graph=s < cots.shape[0] - 1)
        for n, g in zip(names, gs):
            # JAX layout: NCHW conv grads -> NHWC views
            grads[n].append(g.permute(0, 2, 3, 1) if g.ndim == 4 else g)
    probe_grads = {n: torch.stack(v) for n, v in grads.items()}
    return Captured(acts={n: ctx.acts[n] for n in names},
                    probe_grads=probe_grads, logits=logits.detach(),
                    batch_size=x.shape[0])
