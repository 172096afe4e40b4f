"""Activation, output-gradient and parameter-gradient capture: one
forward, S backwards.

Port of ``curvature_tpu/estimators/capture.py`` (classification only).
One forward under a capture :class:`~curvature_tpu_torch.nn.Context`
records every tracked layer's input and adds a zero probe to its
pre-activation output. Each Monte-Carlo label draw only changes the loss
cotangent at the logits, ``(softmax(logits) - onehot(labels_s)) / B``, so
the S backwards are a loop of ``torch.autograd.grad`` over the probes
and/or the tracked layers' ``weight``/``bias`` with ``retain_graph``
(chosen over ``is_grads_batched``, whose vmapped backward does not cover
every op's derivative, e.g. cuDNN batch norm). ``need_param_grads`` /
``need_probe_grads`` say which of the two an estimator consumes (JAX
capture.py:121-123, :173-184); autograd computes only the gradients it is
asked for, so the unused path is never computed (KFAC asks for the probes
alone, the gradient-moment estimators for the parameters alone).

Under a compute dtype the caller passes a cast parameter dict (``params``,
applied with ``torch.func.functional_call``) and a cast input; logits,
softmax, one-hot and cotangent then stay in the logits' dtype, as in JAX
(capture.py:74-83). MC labels are drawn from the softmax in f32.
"""
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from curvature_tpu_torch.nn.core import Context, LayerMeta, param_matrix


@dataclass
class Captured:
    """Per-batch capture results.

    acts:        layer -> input, JAX layout (NHWC conv, [B, in] dense).
    probe_grads: layer -> [S, ...preact] dL/dy of the mean loss, JAX
                 layout (NHWC conv, [S, B, out] dense).
    logits:      [B, K] outputs of the forward.
    batch_size:  B.
    param_grads: layer -> [S, out, fan_in(+1)] matrix-view gradients of the
                 mean loss (``nn.core.param_matrix``: (c, kh, kw) columns,
                 the bias column last); empty unless asked for.
    """
    acts: Dict[str, torch.Tensor]
    probe_grads: Dict[str, torch.Tensor]
    logits: torch.Tensor
    batch_size: int
    param_grads: Dict[str, torch.Tensor] = field(default_factory=dict)


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
            params: Optional[Dict[str, torch.Tensor]] = None,
            need_param_grads: bool = True,
            need_probe_grads: bool = True) -> Captured:
    """Capture acts, probe gradients and parameter gradients for the layers
    in ``metas``.

    ``labels`` are [S, B] (or [B]) class labels; ``None`` draws
    ``num_samples`` labels from the model distribution with
    ``generator``. ``params`` (state-dict keys) replace the model's own
    parameters for this forward; the model is not changed. The model runs
    in train mode (batch-statistics BN) and its running statistics are
    left untouched. ``need_param_grads`` / ``need_probe_grads`` switch the
    two gradient outputs; a switched-off one is neither computed nor
    returned.
    """
    weight_keys = [f"{n}.{leaf}" for n, m in metas.items()
                   for leaf in (("weight", "bias") if m.has_bias
                                else ("weight",))]
    if need_param_grads:
        # differentiable copies of the tracked weights (aliases of the
        # model's own or the cast ones): the model's parameters never
        # accumulate a .grad
        params = dict(dict(model.named_parameters()) if params is None
                      else params)
        for k in weight_keys:
            params[k] = params[k].detach().requires_grad_()
    was_training = model.training
    model.train()
    ctx = Context(track=metas, probes=need_probe_grads)
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
    inputs = [ctx.probes[n] for n in names] if need_probe_grads else []
    if need_param_grads:
        inputs += [params[k] for k in weight_keys]
    grads = {n: [] for n in names}
    pgrads = {n: [] for n in names}
    for s in range(cots.shape[0]):
        gs = torch.autograd.grad(logits, inputs, grad_outputs=cots[s],
                                 retain_graph=s < cots.shape[0] - 1)
        if need_probe_grads:
            for n, g in zip(names, gs):
                # JAX layout: NCHW conv grads -> NHWC views
                grads[n].append(g.permute(0, 2, 3, 1) if g.ndim == 4 else g)
            gs = gs[len(names):]
        if need_param_grads:
            by_key = dict(zip(weight_keys, gs))
            for n, m in metas.items():
                # reshape, not view: a channels_last weight's gradient comes
                # back channels_last
                pgrads[n].append(param_matrix(m, by_key[f"{n}.weight"],
                                              by_key.get(f"{n}.bias")))
    return Captured(
        acts={n: ctx.acts[n] for n in names},
        probe_grads=({n: torch.stack(v) for n, v in grads.items()}
                     if need_probe_grads else {}),
        logits=logits.detach(), batch_size=x.shape[0],
        param_grads=({n: torch.stack(v) for n, v in pgrads.items()}
                     if need_param_grads else {}))
