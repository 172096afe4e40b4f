"""Activation, output-gradient and parameter-gradient capture: one
forward, S backwards.

Port of ``curvature_tpu/estimators/capture.py`` for the categorical
losses: classification (``loss='cross_entropy'``, logits [B, K], labels
[S, B]) and the per-token causal-LM Fisher (``loss='lm'``, logits [B, T,
V], labels [S, B, T]; explicit [B, T] labels are told apart from [S, B]
by their rank, JAX :172-181). One forward under a capture
:class:`~curvature_tpu_torch.nn.Context` records every tracked layer's
input and adds a zero probe to its pre-activation output. Each
Monte-Carlo label draw only changes the loss cotangent at the logits,
``(softmax(logits) - onehot(labels_s)) / #positions`` (B, or B*T for
``'lm'``), so
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
(capture.py:74-83). MC labels are drawn from the softmax in f32. Each
sample's cotangent is made just before its backward and freed after it,
so at a 50,257-word vocabulary one ``[B, T, V]`` cotangent exists at a
time.
"""
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.func import functional_call

from curvature_tpu_torch.nn.core import Context, LayerMeta, param_matrix


@dataclass
class Captured:
    """Per-batch capture results.

    acts:        layer -> input, JAX layout (NHWC conv, [B, (T,) in]
                 dense; a stacked layer's [depth, ...]).
    probe_grads: layer -> [S, ...preact] dL/dy of the mean loss, JAX
                 layout (NHWC conv, [S, B, (T,) out] dense; a stacked
                 layer's [S, depth, ...preact]).
    logits:      [B, K] (or [B, T, V]) outputs of the forward.
    batch_size:  the observation count every estimator's scale uses: B,
                 or B*T for ``loss='lm'`` (JAX :219-226).
    param_grads: layer -> [S, (depth,) out, fan_in(+1)] matrix-view
                 gradients of the
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
    """Categorical draws [S, *lead] from the model's output distribution
    (the 'true' Fisher): [S, B] for [B, K] logits, per-token [S, B, T] for
    [B, T, V]."""
    probs = torch.softmax(logits.detach().float(), dim=-1)
    draws = torch.multinomial(probs.reshape(-1, probs.shape[-1]),
                              num_samples, replacement=True,
                              generator=generator)
    return draws.T.reshape((num_samples,) + logits.shape[:-1])


def ce_cotangent(logits: torch.Tensor, labels: torch.Tensor,
                 probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d(mean CE)/d logits = (softmax - onehot) / #positions, #positions
    the product of every leading axis (B, or B*T): logits [*lead, K],
    labels [S, *lead] -> [S, *lead, K]. ``probs``, where given, is the
    softmax of the logits, computed once for every sample."""
    p = torch.softmax(logits.detach(), dim=-1) if probs is None else probs
    # p - onehot as a scatter of -1: the same numbers, without a [*lead, K]
    # int64 one-hot (1.6 GB at B=8, T=512, V=50,257)
    cot = p.expand((labels.shape[0],) + p.shape).clone()
    idx = labels.long()[..., None]
    cot.scatter_add_(-1, idx, torch.full(idx.shape, -1.0, dtype=p.dtype,
                                         device=p.device))
    return cot / math.prod(logits.shape[:-1])


def collect(model, metas: Dict[str, LayerMeta], x: torch.Tensor,
            labels: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            num_samples: int = 1,
            params: Optional[Dict[str, torch.Tensor]] = None,
            need_param_grads: bool = True,
            need_probe_grads: bool = True,
            loss: str = "cross_entropy") -> Captured:
    """Capture acts, probe gradients and parameter gradients for the layers
    in ``metas``.

    ``labels`` are [S, B] (or [B]) class labels, or [S, B, T] (or [B, T])
    token labels for ``loss='lm'``; ``None`` draws
    ``num_samples`` labels from the model distribution with
    ``generator``. ``params`` (state-dict keys) replace the model's own
    parameters for this forward; the model is not changed. The model runs
    in train mode (batch-statistics BN) and its running statistics are
    left untouched. ``need_param_grads`` / ``need_probe_grads`` switch the
    two gradient outputs; a switched-off one is neither computed nor
    returned.
    """
    if loss not in ("cross_entropy", "lm"):
        raise NotImplementedError(
            f"loss {loss!r} is not ported yet (ROADMAP Queue 1 item 6)")
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
    if labels.ndim == (2 if loss == "lm" else 1):
        labels = labels[None]
    probs = torch.softmax(logits.detach(), dim=-1)
    names = list(metas)
    inputs = [ctx.probes[n] for n in names] if need_probe_grads else []
    if need_param_grads:
        inputs += [params[k] for k in weight_keys]
    grads = {n: [] for n in names}
    pgrads = {n: [] for n in names}
    num = labels.shape[0]
    for s in range(num):
        cot = ce_cotangent(logits, labels[s:s + 1], probs)[0]
        gs = torch.autograd.grad(logits, inputs, grad_outputs=cot,
                                 retain_graph=s < num - 1)
        del cot
        if need_probe_grads:
            for n, g in zip(names, gs):
                # JAX layout: NCHW conv grads -> NHWC views
                grads[n].append(g.permute(0, 2, 3, 1)
                                if metas[n].kind == "conv" else g)
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
        logits=logits.detach(),
        batch_size=(math.prod(logits.shape[:-1]) if loss == "lm"
                    else x.shape[0]),
        param_grads=({n: torch.stack(v) for n, v in pgrads.items()}
                     if need_param_grads else {}))
