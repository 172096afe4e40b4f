"""Deterministic and Bayesian model evaluation.

Port of ``eval_nn``/``eval_bnn`` of ``curvature_tpu/eval/evaluate.py``.
The model runs in eval mode (running-statistics BN). The Bayesian eval
loops over the posterior samples, each a parameter dict applied with
``torch.func.functional_call``, and averages the softmax over them.
"""
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _batches(data, device):
    for x, y in data:
        yield torch.as_tensor(x, device=device), np.asarray(y).reshape(-1)


@torch.no_grad()
def eval_nn(model, data: Iterable[Tuple]) -> Tuple[np.ndarray, np.ndarray]:
    """One deterministic pass; returns (softmax [N, K], labels [N])."""
    was_training = model.training
    model.eval()
    probs, labels = [], []
    try:
        for x, y in _batches(data, _device(model)):
            probs.append(torch.softmax(model(x).float(), dim=-1).cpu())
            labels.append(y)
    finally:
        model.train(was_training)
    return torch.cat(probs).numpy(), np.concatenate(labels)


@torch.no_grad()
def eval_bnn(model, estimator, data: Iterable[Tuple], samples: int = 30,
             ensemble_params: Optional[List[Dict[str, torch.Tensor]]] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean softmax over ``samples`` posterior weight draws; returns
    (mean predictions [N, K], labels [N]).

    The ensemble is drawn once (``estimator.ensemble_params``) unless one
    is given, then every data batch runs all samples."""
    if ensemble_params is None:
        ensemble_params = estimator.ensemble_params(samples,
                                                    generator=generator)
    was_training = model.training
    model.eval()
    sums, labels = [], []
    try:
        for x, y in _batches(data, _device(model)):
            total = None
            for params in ensemble_params:
                p = torch.softmax(
                    functional_call(model, params, (x,)).float(), dim=-1)
                total = p if total is None else total + p
            sums.append((total / len(ensemble_params)).cpu())
            labels.append(y)
    finally:
        model.train(was_training)
    return torch.cat(sums).numpy(), np.concatenate(labels)
