"""Deterministic and Bayesian model evaluation.

Port of ``eval_nn``, ``eval_bnn`` (with its ``sample_chunk`` path and the
``stats`` running statistics) and ``eval_nn_and_bnn`` of
``curvature_tpu/eval/evaluate.py`` (reference evaluate.py:94-170). The
model runs in eval mode (running-statistics BN). The Bayesian eval loops
over the posterior samples, each a parameter dict applied with
``torch.func.functional_call``, and averages the softmax over them.
``compute_dtype`` (``--precision bfloat16``) runs the forwards with every
float parameter and the input cast to it (BatchNorm's running statistics
stay f32); the softmax and every metric stay f32. Data batches are (NCHW
input, labels) pairs, or (token ids [B, T], next-token labels [B, T]): a
causal LM's [B, T, V] softmax is scored per token, flattened to [B*T, V]
with the labels to [B*T], as in JAX.

At a vocabulary-sized output ``eval_nn_stats``/``eval_bnn_stats`` reduce
each batch on the device to four numbers per token (``STATS_COLUMNS``);
the Bayesian one accumulates the sample-mean softmax per batch, so no
[N, V] matrix reaches the host (JAX evaluate.py:237-300).

``mesh`` (a :class:`~curvature_tpu_torch.parallel.Mesh`) splits every
batch over its data axis: each rank runs its rows and an all-gather
returns the whole batch's probabilities in batch order, so every rank
holds the same predictions and metrics (JAX ``_mesh_dispatch``, :22-40).
A batch that does not divide the axis runs whole on every rank.
"""
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.parallel.mesh import gather_rows
from curvature_tpu_torch.utils.casting import cast_floats, cast_input


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _batches(data, device):
    for x, y in data:
        yield torch.as_tensor(x, device=device), np.asarray(y).reshape(-1)


def _forward(model, params, x, compute_dtype, mesh=None):
    """Eval-mode softmax [B, K] in f32, with ``params`` (state-dict keys,
    None for the model's own) cast to ``compute_dtype`` with the model's
    other parameters and the input where one is given. Buffers stay as
    they are: BatchNorm normalizes in f32 on f32 running statistics (JAX
    keeps ``batch_stats`` f32). Under ``mesh`` this rank's rows run and
    the probabilities are gathered."""
    if compute_dtype is not None:
        own = dict(model.named_parameters())
        params = cast_floats(dict(own, **(params or {})), compute_dtype)
        x = cast_input(x, compute_dtype)

    def fwd(xs):
        logits = model(xs) if params is None else functional_call(
            model, params, (xs,))
        p = torch.softmax(logits.float(), dim=-1)
        # causal LMs: [B, T, V] -> per-token [B*T, V]
        return p.reshape(-1, p.shape[-1]) if p.ndim > 2 else p
    return gather_rows(mesh, fwd, x)


@torch.no_grad()
def eval_nn(model, data: Iterable[Tuple], compute_dtype=None, mesh=None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """One deterministic pass; returns (softmax [N, K], labels [N])."""
    was_training = model.training
    model.eval()
    probs, labels = [], []
    try:
        for x, y in _batches(data, _device(model)):
            probs.append(_forward(model, None, x, compute_dtype,
                                  mesh).cpu())
            labels.append(y)
    finally:
        model.train(was_training)
    return torch.cat(probs).numpy(), np.concatenate(labels)


@torch.no_grad()
def _ensemble_sums(model, ensemble_params, batches, compute_dtype,
                   keep_samples, mesh=None):
    """Per batch, the softmax summed over the ensemble [B, K] (and, with
    ``keep_samples``, each sample's [S, B, K])."""
    was_training = model.training
    model.eval()
    sums, per_sample = [], []
    try:
        for x, _ in _batches(batches, _device(model)):
            probs = [_forward(model, p, x, compute_dtype, mesh)
                     for p in ensemble_params]
            sums.append(torch.stack(probs).sum(0).cpu())
            if keep_samples:
                per_sample.append(torch.stack(probs).cpu().numpy())
    finally:
        model.train(was_training)
    return torch.cat(sums).numpy(), per_sample


def _running_stats(probs_all: np.ndarray, labels: np.ndarray,
                   samples: int) -> Dict[str, List[float]]:
    """The reference's running statistics over the sample axis: accuracy,
    ECE and entropy of the running mean, each sample's NLL
    (evaluate.py:141-146)."""
    out = {"acc": [], "ece": [], "nll": [], "ent": []}
    running = np.cumsum(probs_all, axis=0)
    for s in range(samples):
        mean_s = running[s] / (s + 1)
        out["acc"].append(float(metrics.accuracy(mean_s, labels)))
        out["ece"].append(float(
            100 * metrics.expected_calibration_error(mean_s, labels)[0]))
        out["nll"].append(float(
            metrics.negative_log_likelihood(probs_all[s], labels)))
        out["ent"].append(float(
            metrics.predictive_entropy(mean_s, mean=True)))
    return out


def eval_bnn(model, estimator, data: Iterable[Tuple], samples: int = 30,
             ensemble_params: Optional[List[Dict[str, torch.Tensor]]] = None,
             generator: Optional[torch.Generator] = None,
             stats: bool = False, sample_chunk: Optional[int] = None,
             compute_dtype=None, mesh=None
             ) -> Tuple[np.ndarray, np.ndarray, Dict[str, List[float]]]:
    """Mean softmax over ``samples`` posterior weight draws; returns (mean
    predictions [N, K], labels [N], running statistics).

    The ensemble is drawn once (``estimator.ensemble_params``) unless one
    is given, whose members then set the count; every data batch runs all
    of them. ``sample_chunk`` bounds how many sampled parameter sets exist
    at once: the ensemble is drawn and run a chunk at a time. ``stats``
    fills the reference's running statistics (empty lists otherwise)."""
    batches = list(data)
    labels = np.concatenate([np.asarray(y).reshape(-1) for _, y in batches])
    if ensemble_params is not None:
        ensembles = [ensemble_params]
    else:
        # each chunk drawn when it runs: at most sample_chunk sets exist
        step = min(sample_chunk or samples, samples)
        ensembles = (estimator.ensemble_params(min(step, samples - i),
                                               generator=generator)
                     for i in range(0, samples, step))
    total, per_sample, members = None, [], 0
    for ens in ensembles:
        members += len(ens)
        s, kept = _ensemble_sums(model, ens, batches, compute_dtype, stats,
                                 mesh)
        total = s if total is None else total + s
        if stats:
            per_sample.append(np.concatenate(kept, axis=1))
    stats_list = {"acc": [], "ece": [], "nll": [], "ent": []}
    if stats:
        stats_list = _running_stats(np.concatenate(per_sample, axis=0),
                                    labels, members)
    return total / members, labels, stats_list


def eval_nn_and_bnn(model, estimator, data, samples: int = 30,
                    generator: Optional[torch.Generator] = None,
                    stats: bool = False, compute_dtype=None,
                    sample_chunk: Optional[int] = None, mesh=None):
    """Deterministic and Bayesian predictions over the same data
    (reference eval_nn_and_bnn, evaluate.py:155-170); returns
    (predictions, bnn_predictions, labels, bnn_stats)."""
    batches = list(data)
    predictions, labels = eval_nn(model, batches, compute_dtype, mesh)
    bnn_predictions, _, bnn_stats = eval_bnn(
        model, estimator, batches, samples, generator=generator,
        stats=stats, sample_chunk=sample_chunk, compute_dtype=compute_dtype,
        mesh=mesh)
    return predictions, bnn_predictions, labels, bnn_stats


# -- sufficient-statistics eval (vocab-scale outputs) -------------------------
#: per-token columns: probability of the label (NLL), max probability (ECE
#: bins), argmax == label (accuracy, ECE), entropy (OOD scores)
STATS_COLUMNS = ("p_label", "confidence", "correct", "entropy")


def _probs_to_stats(p2d: torch.Tensor, y) -> torch.Tensor:
    """[N, K] probabilities and [N] labels -> [N, 4] STATS_COLUMNS, on the
    probabilities' device."""
    y = torch.as_tensor(np.asarray(y).reshape(-1), device=p2d.device).long()
    p_label = p2d.gather(1, y[:, None])[:, 0]
    conf = p2d.max(dim=1).values
    correct = (p2d.argmax(dim=1) == y).float()
    ent = -(p2d * torch.log(p2d.clamp_min(1e-12))).sum(dim=1)
    return torch.stack([p_label, conf, correct, ent], dim=1)


@torch.no_grad()
def eval_nn_stats(model, data: Iterable[Tuple], compute_dtype=None,
                  mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`eval_nn` reduced on the device to the [N, 4]
    STATS_COLUMNS; returns (stats, labels [N])."""
    was_training = model.training
    model.eval()
    stats, labels = [], []
    try:
        for x, y in _batches(data, _device(model)):
            p = _forward(model, None, x, compute_dtype, mesh)
            stats.append(_probs_to_stats(p, y).cpu())
            labels.append(y)
    finally:
        model.train(was_training)
    return torch.cat(stats).numpy(), np.concatenate(labels)


@torch.no_grad()
def eval_bnn_stats(model, estimator, data: Iterable[Tuple],
                   samples: int = 30,
                   generator: Optional[torch.Generator] = None,
                   sample_chunk: Optional[int] = None, compute_dtype=None,
                   ensemble_params: Optional[List[Dict]] = None, mesh=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`eval_bnn` reduced on the device: per batch, the sample-mean
    softmax accumulates there and collapses to STATS_COLUMNS. The
    posterior is drawn ``sample_chunk`` members at a time and redrawn for
    every batch from the generator's starting state, so each batch sees
    the same ensemble and at most a chunk of sampled parameter sets
    exists at once (JAX :269-300). A given ``ensemble_params`` is used
    as it is. Returns (stats [N, 4], labels [N])."""
    device = _device(model)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    start = generator.get_state()
    chunk = min(sample_chunk or samples, samples)

    def ensembles():
        if ensemble_params is not None:
            yield ensemble_params
            return
        generator.set_state(start)
        for i in range(0, samples, chunk):
            yield estimator.ensemble_params(min(chunk, samples - i),
                                            generator=generator)

    was_training = model.training
    model.eval()
    stats, labels = [], []
    try:
        for x, y in _batches(data, device):
            total, members = None, 0
            for ens in ensembles():
                for params in ens:
                    p = _forward(model, params, x, compute_dtype, mesh)
                    total = p if total is None else total + p
                members += len(ens)
            stats.append(_probs_to_stats(total / members, y).cpu())
            labels.append(y)
    finally:
        model.train(was_training)
    return torch.cat(stats).numpy(), np.concatenate(labels)
