"""Adversarial evaluation: the Fast Gradient Sign Method.

Port of ``curvature_tpu/eval/attacks.py`` (reference datasets.py:29-64 and
evaluate.py:19-91). The input gradient of the mean cross-entropy comes from
autograd; the perturbed batch is clamped to the batch's own value range.
In the Bayesian variant each posterior sample attacks with its own weights
and predicts on its own adversarial batch; the predictions are averaged
over the samples. The model runs in eval mode.
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from curvature_tpu_torch.eval import metrics


def _logits(model, params, x):
    return model(x) if params is None else functional_call(model, params,
                                                           (x,))


def fgsm(model, x: torch.Tensor, labels, epsilon: float = 0.1,
         params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """x + epsilon * sign(dL/dx), clamped to [min(x), max(x)]
    (datasets.py:51-62); ``params`` (state-dict keys) replace the model's
    own, as a posterior sample does."""
    was_training = model.training
    model.eval()
    try:
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            labels = torch.as_tensor(labels, device=x.device).long()
            loss = F.cross_entropy(_logits(model, params, xx).float(),
                                   labels)
            grad, = torch.autograd.grad(loss, xx)
    finally:
        model.train(was_training)
    return torch.clamp(x + epsilon * torch.sign(grad), x.min(), x.max())


def _stats_dict(predictions, labels, epsilon) -> Dict:
    return {
        "eps": float(epsilon),
        "acc": float(metrics.accuracy(predictions, labels)),
        "ece1": float(100 * metrics.expected_calibration_error(
            predictions, labels)[0]),
        "ece2": float(100 * metrics.calibration_curve(predictions,
                                                      labels)[0]),
        "nll": float(metrics.negative_log_likelihood(predictions, labels)),
        "ent": float(metrics.predictive_entropy(predictions, mean=True)),
    }


@torch.no_grad()
def _adv_probs(model, params, x, y, epsilon):
    adv = fgsm(model, x, y, epsilon, params)
    was_training = model.training
    model.eval()
    try:
        return torch.softmax(_logits(model, params, adv).float(), dim=-1)
    finally:
        model.train(was_training)


def _run(model, data, per_batch, epsilon, stats):
    device = next(model.parameters()).device
    probs_list, labels_list = [], []
    for x, y in data:
        x = torch.as_tensor(x, device=device)
        y = np.asarray(y).reshape(-1)
        probs_list.append(per_batch(x, torch.as_tensor(y, device=device))
                          .cpu().numpy())
        labels_list.append(y)
    predictions = np.concatenate(probs_list)
    labels = np.concatenate(labels_list)
    return predictions, labels, (_stats_dict(predictions, labels, epsilon)
                                 if stats else None)


def eval_fgsm(model, data, epsilon: float = 0.1, stats: bool = True
              ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Deterministic adversarial eval (reference eval_fgsm,
    evaluate.py:19-57): (predictions, labels, metrics)."""
    return _run(model, data,
                lambda x, y: _adv_probs(model, None, x, y, epsilon),
                epsilon, stats)


def eval_fgsm_bnn(model, estimator, data, samples: int = 30,
                  epsilon: float = 0.1,
                  generator: Optional[torch.Generator] = None,
                  stats: bool = True, ensemble_params=None,
                  ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Bayesian adversarial eval (reference eval_fgsm_bnn,
    evaluate.py:60-91): each posterior sample attacks and predicts with
    its own weights; the mean over the samples."""
    if ensemble_params is None:
        ensemble_params = estimator.ensemble_params(samples,
                                                    generator=generator)

    def per_batch(x, y):
        total = None
        for p in ensemble_params:
            pr = _adv_probs(model, p, x, y, epsilon)
            total = pr if total is None else total + pr
        return total / len(ensemble_params)
    return _run(model, data, per_batch, epsilon, stats)
