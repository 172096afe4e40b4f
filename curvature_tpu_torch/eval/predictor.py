"""Serving-style Bayesian predictor.

Port of ``curvature_tpu/eval/predictor.py``: a model and a fitted,
inverted estimator bundled into a predictive distribution with its
uncertainty decomposition,

  * predictive mean:     E_s[softmax(f(theta_s, x))]
  * total uncertainty:   H(mean)                       (predictive entropy)
  * aleatoric:           E_s[H(softmax_s)]
  * epistemic (BALD):    H(mean) - E_s[H(softmax_s)]   (mutual information)

The posterior ensemble is drawn once, at construction (or given as
``ensemble_params``); each prediction runs it over the batch, the model
in eval mode. With a ``mesh`` the ensemble splits over its sample axis:
each rank runs its members and an all-gather restores the ensemble order
(JAX predictor.py:112-120); a count that does not divide the axis runs
whole on every rank.
"""
from typing import Dict, List, NamedTuple, Optional

import torch

from curvature_tpu_torch.eval.predictive import (
    laplace_bridge, make_linearized_ensemble_fn, make_logit_ensemble_fn,
    moments, probit_mean_field)
from curvature_tpu_torch.parallel.mesh import all_gather
from curvature_tpu_torch.utils.casting import cast_floats


class Prediction(NamedTuple):
    mean: torch.Tensor          # [B, K] posterior-mean class probabilities
    entropy: torch.Tensor       # [B] total predictive entropy
    aleatoric: torch.Tensor     # [B] expected per-sample entropy
    epistemic: torch.Tensor     # [B] BALD mutual information


def _entropy(p: torch.Tensor) -> torch.Tensor:
    return -torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)).sum(-1)


def _decompose(mean: torch.Tensor, logits_s: torch.Tensor) -> Prediction:
    """Entropies of ``mean``; the aleatoric part from the per-sample
    softmax of ``logits_s`` [S, B, K]."""
    total = _entropy(mean)
    aleatoric = _entropy(torch.softmax(logits_s, dim=-1)).mean(0)
    return Prediction(mean, total, aleatoric, total - aleatoric)


class BayesianPredictor:
    def __init__(self, model, estimator, samples: int = 30,
                 generator: Optional[torch.Generator] = None,
                 ensemble_params: Optional[List[Dict]] = None,
                 compute_dtype=None, mesh=None, sample_axis: str = "sample"):
        """``compute_dtype=torch.bfloat16`` runs the ensemble forwards in
        bf16; the softmax and the entropies stay f32. ``mesh`` splits the
        ensemble over ``sample_axis``."""
        self.model = model
        if ensemble_params is None:
            ensemble_params = estimator.ensemble_params(samples,
                                                        generator=generator)
        self.ensemble = [cast_floats(p, compute_dtype)
                         for p in ensemble_params]
        self.mean_params = cast_floats(estimator.mean_params, compute_dtype)
        self.samples = len(self.ensemble)
        self._logits = make_logit_ensemble_fn(model, compute_dtype)
        self._linearized = make_linearized_ensemble_fn(model, compute_dtype)
        # this rank's members, and the group that gathers their logits
        self._members, self._group = self.ensemble, None
        rows = None if mesh is None else mesh.rows(self.samples,
                                                   sample_axis)
        if rows is not None and mesh.size(sample_axis) > 1:
            self._members = self.ensemble[rows]
            self._group = mesh.group(sample_axis)

    def _logits_s(self, x) -> torch.Tensor:
        return all_gather(self._logits(self._members, self._input(x)),
                          self._group)

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=next(self.model.parameters())
                               .device)

    def __call__(self, x) -> Prediction:
        """The MC predictive: the mean softmax over the ensemble."""
        logits_s = self._logits_s(x)
        return _decompose(torch.softmax(logits_s, dim=-1).mean(0), logits_s)

    def predict_closed_form(self, x, method: str = "probit") -> Prediction:
        """Closed-form predictive from the ensemble's logit moments
        (probit mean-field or the Laplace bridge's Dirichlet mean),
        reusing the resident ensemble. The decomposition keeps the MC
        definitions (entropy of the closed-form mean, aleatoric part from
        the per-sample logits); the closed-form mean is not the MC mean,
        so the BALD difference can dip slightly below zero."""
        if method not in ("probit", "bridge"):
            raise ValueError(f"unknown closed-form method {method!r}")
        logits_s = self._logits_s(x)
        mu, var = moments(logits_s)
        mean = probit_mean_field(mu, var) if method == "probit" \
            else laplace_bridge(mu, var)[1]
        return _decompose(mean, logits_s)

    def predict_linearized(self, x) -> Prediction:
        """GLM / linearized-Laplace predictive: the resident samples
        through the MAP-linearized network (one jvp per sample). Equals
        ``__call__`` when the logits are linear in the parameters."""
        _, logits_s = self._linearized(self.mean_params, self._members,
                                       self._input(x))
        logits_s = all_gather(logits_s, self._group)
        return _decompose(torch.softmax(logits_s, dim=-1).mean(0), logits_s)
