"""Adversarial evaluation: the Fast Gradient Sign Method.

Port of ``curvature_tpu/eval/attacks.py`` (reference datasets.py:29-64 and
evaluate.py:19-91). The input gradient of the mean cross-entropy comes from
autograd; the perturbed batch is clamped to the batch's own value range.
In the Bayesian variant each posterior sample attacks with its own weights
and predicts on its own adversarial batch; the predictions are averaged
over the samples. The model runs in eval mode. :func:`make_fgsm_fn` builds
the attack once (JAX :18-31); ``fgsm``, ``eval_fgsm`` and ``eval_fgsm_bnn``
go through it.
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from curvature_tpu_torch.estimators.capture import softmax_cross_entropy
from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.eval.evaluate import eval_mode


def _logits(model, params, x):
    return model(x) if params is None else functional_call(model, params,
                                                           (x,))


def make_fgsm_fn(model):
    """The FGSM perturbation ``attack(params, x, labels, epsilon)`` ->
    x + epsilon * sign(dL/dx), clamped to [min(x), max(x)]
    (datasets.py:51-62), L the mean cross-entropy of the eval-mode logits
    (:func:`~curvature_tpu_torch.estimators.capture.softmax_cross_entropy`
    in f32); ``params`` (state-dict keys) replace the model's own, as a
    posterior sample does, or None for them (JAX :18-31)."""
    def attack(params: Optional[Dict[str, torch.Tensor]], x: torch.Tensor,
               labels, epsilon: float) -> torch.Tensor:
        with eval_mode(model), torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            labels = torch.as_tensor(labels, device=x.device).long()
            loss = softmax_cross_entropy(
                _logits(model, params, xx).float(), labels)
            grad, = torch.autograd.grad(loss, xx)
        return torch.clamp(x + epsilon * torch.sign(grad), x.min(), x.max())
    return attack


def fgsm(model, x: torch.Tensor, labels, epsilon: float = 0.1,
         params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """One FGSM step on ``x`` (:func:`make_fgsm_fn`)."""
    return make_fgsm_fn(model)(params, x, labels, epsilon)


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
def _adv_probs(model, attack, params, x, y, epsilon):
    adv = attack(params, x, y, epsilon)
    with eval_mode(model):
        return torch.softmax(_logits(model, params, adv).float(), dim=-1)


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
    attack = make_fgsm_fn(model)
    return _run(model, data,
                lambda x, y: _adv_probs(model, attack, None, x, y, epsilon),
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
    attack = make_fgsm_fn(model)

    def per_batch(x, y):
        total = None
        for p in ensemble_params:
            pr = _adv_probs(model, attack, p, x, y, epsilon)
            total = pr if total is None else total + pr
        return total / len(ensemble_params)
    return _run(model, data, per_batch, epsilon, stats)
