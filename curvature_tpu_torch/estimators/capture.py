"""Activation, output-gradient and parameter-gradient capture: one
forward, S backwards.

Port of ``curvature_tpu/estimators/capture.py``: classification
(``loss='cross_entropy'``, logits [B, K], labels [S, B]), the per-token
causal-LM Fisher (``loss='lm'``, logits [B, T, V], labels [S, B, T]) and
unit-variance regression (``loss='gaussian'``, predictions [B, D],
targets [S, B, D]); explicit [B, T] or [B, D] labels are told apart from
[S, B] by their rank (JAX :193-201). One forward under a capture
:class:`~curvature_tpu_torch.nn.Context` records every tracked layer's
input and adds a zero probe to its pre-activation output. Each
Monte-Carlo label draw only changes the loss cotangent at the logits,
``(softmax(logits) - onehot(labels_s)) / #positions`` (B, or B*T for
``'lm'``), or ``(f - y_s) / B`` for ``'gaussian'``, so
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
(capture.py:74-83). MC labels are drawn from the softmax in f32 (a
regression's targets as the predictions plus standard-normal noise). Each
sample's cotangent is made just before its backward and freed after it,
so at a 50,257-word vocabulary one ``[B, T, V]`` cotangent exists at a
time.

Under a mesh (``Estimator.use_mesh``) each rank captures its block of the
batch, of the label draws and of the tokens, described by a
:class:`Shard`. The context carries the data group, so BatchNorm
normalizes over the whole batch, and, where the token dim of ``[B, T]``
LM inputs is split (``seq_mode='tokens'``, a model with ``splits_tokens``),
the seq group and the block's
first position: the model offsets its position ids and its attention
gathers the keys and values of every token (models/gpt.py). Labels drawn
here come from the whole batch's logits, gathered over the data and token
ranks, with the caller's generator (one process's draws); the rank keeps
its block. Every cotangent is divided by the *global* position count, so
the probe gradients are those of the global mean loss on this rank's
tokens. The parameter gradients are summed over the data group (and the
token group) (the global batch gradient) and gathered over the sample
group (every draw) before any estimator squares them. ``batch_size`` is
the global count.

``gram_probe_names`` fuses the output-gradient capture of those layers
(JAX capture.py:127-230): each gets a zero f32 ``[out, out]`` accumulator
behind a ``GramTap`` (nn/core.py) instead of a probe, and each sample's
``autograd.grad`` returns that layer's token Gram ``sum_n g_n g_n^T``
(``Captured.probe_grams``, ``[S, out, out]``) in place of its
``[S, ...preact]`` gradient, all that KFAC's G factor reads.
"""
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from curvature_tpu_torch.nn.core import (
    Context, LayerMeta, Routes, param_key, param_matrix)
from curvature_tpu_torch.parallel.mesh import (
    all_gather, all_reduce_tree, group_size)
from curvature_tpu_torch.utils import monitor


@dataclass
class Shard:
    """One rank's part of a meshed capture.

    data_group:   process group of the ranks splitting the batch (None:
                  not split).
    sample_group: process group of the ranks splitting the label draws.
    seq_group:    process group of the ranks splitting the token dim of
                  ``[B, T]`` inputs (``seq_mode='tokens'``), else None.
    sum_group:    the ranks that split tokens and draws and share this
                  rank's parameter and state blocks: the factor-delta sum.
    batch:        the global batch size B.
    tokens:       the global token count T of ``[B, T]`` LM inputs (1
                  otherwise).
    divisor:      ranks splitting the tokens (data times seq): each rank's
                  delta is weighted by one over it.
    rows:         this rank's rows of the batch.
    samples:      this rank's label draws.
    seq_mode:     ``'tokens'`` (the token dim split), ``'rows'`` (the
                  forward whole, conv Grams on a block of output rows) or
                  None (seq not split).
    seq_index:    this rank's index on the seq axis.
    seq_size:     the ranks on the seq axis (1 where it is not split).
    token_rows:   this rank's tokens under ``'tokens'``.
    """
    data_group: Any
    sample_group: Any
    seq_group: Any
    sum_group: Any
    batch: int
    tokens: int
    divisor: int
    rows: slice
    samples: slice
    seq_mode: Optional[str] = None
    seq_index: int = 0
    seq_size: int = 1
    token_rows: Optional[slice] = None


@dataclass
class Captured:
    """Per-batch capture results.

    acts:        layer -> input, JAX layout (NHWC conv, [B, (T,) in]
                 dense; a stacked layer's [depth, ...]).
    probe_grads: layer -> [S, ...preact] dL/dy of the mean loss, JAX
                 layout (NHWC conv, [S, B, (T,) out] dense; a stacked
                 layer's [S, depth, ...preact], contiguous).
    logits:      [B, K] (or [B, T, V]) outputs of the forward.
    batch_size:  the observation count every estimator's scale uses: B,
                 or B*T for ``loss='lm'`` (JAX :219-226).
    param_grads: layer -> [S, (depth,) out, fan_in(+1)] matrix-view
                 gradients of the
                 mean loss (``nn.core.param_matrix``: (c, kh, kw) columns,
                 the bias column last); empty unless asked for.
    probe_grams: layer -> [S, out, out] per-sample token Grams of the
                 layers captured through a gram tap (which then have no
                 ``probe_grads`` entry); None without taps.
    probe_gram_ntok: layer -> the token count N of each such Gram.
    routes:      layer -> the ``Routes`` of an expert layer whose
                 ``acts``/``probe_grads`` are its routed rows (``collect``'s
                 ``routed``); empty otherwise.
    shard:       the rank's :class:`Shard` of a meshed capture, else None.
    """
    acts: Dict[str, torch.Tensor]
    probe_grads: Dict[str, torch.Tensor]
    logits: torch.Tensor
    batch_size: int
    param_grads: Dict[str, torch.Tensor] = field(default_factory=dict)
    probe_grams: Optional[Dict[str, torch.Tensor]] = None
    probe_gram_ntok: Optional[Dict[str, int]] = None
    routes: Dict[str, Routes] = field(default_factory=dict)
    shard: Optional[Shard] = None


def sample_labels(logits: torch.Tensor, num_samples: int,
                  generator: Optional[torch.Generator] = None,
                  loss: str = "cross_entropy") -> torch.Tensor:
    """Draws from the model's output distribution (the 'true' Fisher):
    categorical [S, *lead] ([S, B] for [B, K] logits, per-token [S, B, T]
    for [B, T, V]); for ``loss='gaussian'`` the predictions plus
    unit-variance noise, [S, B, D] (JAX :99-116)."""
    if loss == "gaussian":
        f = logits.detach()
        return f[None] + torch.randn((num_samples,) + f.shape,
                                     generator=generator, dtype=f.dtype,
                                     device=f.device)
    probs = torch.softmax(logits.detach().float(), dim=-1)
    draws = torch.multinomial(probs.reshape(-1, probs.shape[-1]),
                              num_samples, replacement=True,
                              generator=generator)
    return draws.T.reshape((num_samples,) + logits.shape[:-1])


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean cross-entropy from logits (the reference's criterion,
    scripts/factors.py:39). Rank-polymorphic as JAX's (:65-71): ``[B,
    K]`` logits with ``[B]`` labels, or a language model's ``[B, T, V]``
    with ``[B, T]``, the mean then over all B*T token positions."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def ce_cotangent(logits: torch.Tensor, labels: torch.Tensor,
                 probs: Optional[torch.Tensor] = None,
                 count: Optional[int] = None) -> torch.Tensor:
    """d(mean CE)/d logits = (softmax - onehot) / #positions, #positions
    the product of every leading axis (B, or B*T) or ``count`` (a split
    batch's global count): logits [*lead, K], labels [S, *lead] -> [S,
    *lead, K]. ``probs``, where given, is the softmax of the logits,
    computed once for every sample."""
    p = torch.softmax(logits.detach(), dim=-1) if probs is None else probs
    # p - onehot as a scatter of -1: the same numbers, without a [*lead, K]
    # int64 one-hot (1.6 GB at B=8, T=512, V=50,257)
    cot = p.expand((labels.shape[0],) + p.shape).clone()
    idx = labels.long()[..., None]
    cot.scatter_add_(-1, idx, torch.full(idx.shape, -1.0, dtype=p.dtype,
                                         device=p.device))
    return cot / (count or math.prod(logits.shape[:-1]))


def gaussian_nll(preds: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """Mean unit-variance Gaussian NLL, 0.5 * mean over the batch of
    ||f - y||^2: the regression loss whose Fisher the estimators cover
    (JAX :86-89)."""
    return 0.5 * ((preds - targets) ** 2).sum(dim=-1).mean()


def gaussian_cotangent(preds: torch.Tensor, targets: torch.Tensor,
                       count: Optional[int] = None) -> torch.Tensor:
    """d(mean 0.5 ||f - y||^2)/d f = (f - y) / B (``count``: a split
    batch's global B): preds [B, D], targets [S, B, D] -> [S, B, D] (JAX
    :92-94)."""
    return (preds.detach() - targets.to(preds.dtype)) \
        / (count or preds.shape[0])


def collect(model, metas: Dict[str, LayerMeta], x: torch.Tensor,
            labels: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            num_samples: int = 1,
            params: Optional[Dict[str, torch.Tensor]] = None,
            need_param_grads: bool = True,
            need_probe_grads: bool = True,
            loss: str = "cross_entropy",
            gram_probe_names=frozenset(),
            shard: Optional[Shard] = None,
            remat: bool = False, routed: bool = False) -> Captured:
    """Capture acts, probe gradients and parameter gradients for the layers
    in ``metas``.

    ``labels`` are [S, B] (or [B]) class labels, [S, B, T] (or [B, T])
    token labels for ``loss='lm'``, or [S, B, D] (or [B, D]) regression
    targets for ``loss='gaussian'``; ``None`` draws
    ``num_samples`` labels from the model distribution with
    ``generator``. ``params`` (state-dict keys) replace the model's own
    parameters for this forward; the model is not changed. The model runs
    in train mode (batch-statistics BN) and its running statistics are
    left untouched. ``need_param_grads`` / ``need_probe_grads`` switch the
    two gradient outputs; a switched-off one is neither computed nor
    returned. ``gram_probe_names`` names the layers whose output gradient
    comes back as its per-sample token Gram (``probe_grams``); it needs
    ``need_probe_grads``. ``shard`` makes ``x`` and ``labels`` this
    rank's block of a meshed capture (the module docstring).
    ``routed`` keeps the expert layers' routed rows (the module
    docstring).
    """
    if loss not in ("cross_entropy", "lm", "gaussian"):
        raise ValueError(f"unknown loss {loss!r}: 'cross_entropy', 'lm' or "
                         "'gaussian'")
    taps = {n: 1 if metas[n].kind == "conv" else -1
            for n in sorted(frozenset(gram_probe_names) & set(metas))}
    if taps and not need_probe_grads:
        raise ValueError("gram_probe_names requires need_probe_grads")
    weight_keys = [param_key(n, leaf) for n, m in metas.items()
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
    ctx = Context(track=metas, probes=need_probe_grads, gram_taps=taps,
                  data_group=None if shard is None else shard.data_group,
                  seq_group=None if shard is None else shard.seq_group,
                  seq_offset=(shard.token_rows.start if shard is not None
                              and shard.token_rows is not None else 0))
    def forward(inp):
        return (model(inp, ctx) if params is None
                else functional_call(model, params, (inp, ctx)))
    try:
        with monitor.span("capture.forward"):
            logits = (checkpoint(forward, x, use_reentrant=False) if remat
                      else forward(x))
    finally:
        model.train(was_training)
    # the recomputation in the backward records again into ctx: keep the
    # forward's captures
    acts, probes = dict(ctx.acts), dict(ctx.probes)
    routes = {n: r for n, r in ctx.routes.items() if n in metas}
    tap_accs, tap_tokens = dict(ctx.taps), dict(ctx.tap_tokens)
    if labels is None:
        full = logits if shard is None else all_gather(all_gather(
            logits.detach(), shard.data_group), shard.seq_group, 1)
        labels = (sample_labels(full, num_samples, generator, loss)
                  if loss == "gaussian"
                  else sample_labels(full, num_samples, generator))
        if shard is not None:
            labels = labels[shard.samples][:, shard.rows]
            if shard.token_rows is not None:
                labels = labels[:, :, shard.token_rows]
    labels = torch.as_tensor(labels, device=logits.device)
    if labels.ndim == (2 if loss in ("lm", "gaussian") else 1):
        labels = labels[None]
    probs = (None if loss == "gaussian"
             else torch.softmax(logits.detach(), dim=-1))
    names = [n for n in metas if n not in taps]
    # a stacked layer's per-depth probe leaves (nn/core.py), in depth order
    slots = ({n: len(probes[n]) for n in names
              if isinstance(probes[n], list)} if need_probe_grads else {})
    inputs = ([p for n in names for p in (probes[n] if n in slots
                                          else [probes[n]])]
              if need_probe_grads else [])
    inputs += [tap_accs[n] for n in taps]
    if need_param_grads:
        inputs += [params[k] for k in weight_keys]
    grads = {n: [] for n in names if n not in slots}
    # [S, depth, ...preact], each depth's gradient written once per draw
    stacked = {}
    grams = {n: [] for n in taps}
    pgrads = {n: [] for n in metas}
    num = labels.shape[0]
    # the observation count of every scale: B, or B*T for 'lm'; global
    # under a shard
    batch_size = (math.prod(logits.shape[:-1]) if loss == "lm"
                  else x.shape[0])
    count = None
    if shard is not None:
        batch_size = shard.batch * (shard.tokens if loss == "lm" else 1)
        count = batch_size
    def jax_layout(n, g):
        # NCHW conv grads -> NHWC views
        return g.permute(0, 2, 3, 1) if metas[n].kind == "conv" else g
    with monitor.span("capture.backward",
                      probe_slots=sum(slots.values())):
        for s in range(num):
            cot = (gaussian_cotangent(logits, labels[s], count)
                   if probs is None
                   else ce_cotangent(logits, labels[s:s + 1], probs,
                                     count)[0])
            gs = iter(torch.autograd.grad(logits, inputs, grad_outputs=cot,
                                          retain_graph=s < num - 1))
            del cot
            for n in names if need_probe_grads else ():
                if n not in slots:
                    grads[n].append(jax_layout(n, next(gs)))
                    continue
                for i in range(slots[n]):
                    g = jax_layout(n, next(gs))
                    if n not in stacked:
                        stacked[n] = g.new_empty((num, slots[n]) + g.shape)
                    stacked[n][s, i] = g
            for n in taps:
                grams[n].append(next(gs))
            if need_param_grads:
                by_key = dict(zip(weight_keys, gs))
                for n, m in metas.items():
                    # reshape, not view: a channels_last weight's gradient
                    # comes back channels_last
                    pgrads[n].append(param_matrix(
                        m, by_key[param_key(n, "weight")],
                        by_key.get(param_key(n, "bias"))))
    param_grads = ({n: torch.stack(v) for n, v in pgrads.items()}
                   if need_param_grads else {})
    if shard is not None and param_grads:
        # the global batch gradient of every draw, on every rank
        all_reduce_tree(list(param_grads.values()), shard.data_group)
        if group_size(shard.seq_group) > 1:
            all_reduce_tree(list(param_grads.values()), shard.seq_group)
        param_grads = {n: all_gather(g, shard.sample_group)
                       for n, g in param_grads.items()}
    acts = {n: acts[n] for n in metas}
    probe_grads = ({n: stacked[n] if n in slots else torch.stack(grads[n])
                    for n in names} if need_probe_grads else {})
    if not routed:
        for n, r in routes.items():
            acts[n] = r.dense(acts[n])
            if n in probe_grads:
                probe_grads[n] = r.dense(probe_grads[n])
        routes = {}
    return Captured(
        acts=acts,
        probe_grads=probe_grads,
        logits=logits.detach(),
        batch_size=batch_size,
        param_grads=param_grads,
        probe_grams=({n: torch.stack(v) for n, v in grams.items()}
                     if taps else None),
        probe_gram_ntok=tap_tokens if taps else None,
        routes=routes,
        shard=shard)
