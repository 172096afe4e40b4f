"""Laplace log marginal likelihood (model evidence).

Port of ``curvature_tpu/eval/marglik.py``. With P the damped posterior
precision the sampler uses and a Gaussian prior N(0, 1/add) whose
precision is the ``add`` damping, the 2pi factors of the prior and of the
Laplace volume cancel, leaving

    log p(D) = -NLL_sum(theta*)
               + (1/2) * sum_layers [ d_l log(add_l) - add_l ||theta_l||^2 ]
               - (1/2) logdet P(add, multiply).

The MAP NLL is constant in (add, multiply), so a damping candidate costs
one logdet per layer and no forward pass (``--objective marglik`` of
``pipelines/hyper.py``). Only the parameters the estimator tracks enter;
the others are held at the MAP (subnetwork Laplace).
"""
import math
from typing import Iterable

import numpy as np
import torch

from curvature_tpu_torch.estimators.base import normalize_damping
from curvature_tpu_torch.eval.evaluate import _device
from curvature_tpu_torch.eval.predictive import eval_mode
from curvature_tpu_torch.nn.core import param_key, param_matrix


@torch.no_grad()
def dataset_map_nll(model, data: Iterable, loss: str = "cross_entropy"
                    ) -> float:
    """Sum of -log p(y | x, theta_MAP) over a dataset (natural log).
    Labels are [B] classes or [B, T] per-token LM labels;
    ``loss='gaussian'`` scores unit-variance regression, 0.5 ||y - f||^2
    + (D/2) log 2pi per example."""
    device = _device(model)
    total = 0.0
    with eval_mode(model):
        for x, y in data:
            out = model(torch.as_tensor(x, device=device)).float()
            y = torch.as_tensor(np.asarray(y), device=device)
            if loss == "gaussian":
                sq = ((out - y) ** 2).sum(-1)
                nll = (0.5 * sq + 0.5 * out.shape[-1]
                       * math.log(2 * math.pi)).sum()
            else:
                logp = torch.log_softmax(out, dim=-1)
                nll = -logp.gather(-1, y.long()[..., None]).sum()
            total += float(nll)
    return total


def covered_params(est):
    """(d, ||theta||^2) per tracked layer, in meta order (float64)."""
    counts, sq = [], []
    for name, meta in est.metas.items():
        mat = param_matrix(meta, est.mean_params[param_key(name, "weight")],
                           est.mean_params.get(param_key(name, "bias")))
        counts.append(mat.numel())
        sq.append(float((mat.float() ** 2).sum()))
    return np.asarray(counts, np.float64), np.asarray(sq, np.float64)


def marglik_gradient_tune(est, nll_sum: float, steps: int = 200,
                          lr: float = 0.1, pre_scale: float = 1.0,
                          init=(0.0, 0.0), per_layer: bool = False):
    """Tune the damping by gradient ascent on the Laplace evidence: Adam
    (``torch.optim.Adam``, optax's defaults) on (log10 norm, log10 scale),
    shared or, with ``per_layer``, all 2L per-layer dampings jointly,
    differentiating ``logdet_state`` by autograd (Cholesky and eigh
    gradients included). The MAP NLL is a constant and never recomputed.
    JAX runs the ascent as one ``lax.scan``; here it is a loop of
    ``steps`` steps.

    Returns ``{"norms", "scales", "log_marglik", "trace"}``: per-layer
    arrays (shared values broadcast), the final evidence, and the
    negative evidence before each step.
    """
    num_layers = len(est.metas)
    counts, theta_sq = covered_params(est)
    dev, dtype = est.device, est.dtype
    counts_t = torch.as_tensor(counts, dtype=dtype, device=dev)
    theta_t = torch.as_tensor(theta_sq, dtype=dtype, device=dev)

    def neg_evidence(params):
        add = (10.0 ** params[0]).expand(num_layers)
        mult = (pre_scale * 10.0 ** params[1]).expand(num_layers)
        prior = 0.5 * (counts_t * torch.log(add) - add * theta_t).sum()
        return -(prior - 0.5 * est.logdet_state(est.state, add, mult))

    shape = (2, num_layers) if per_layer else (2,)
    params = torch.as_tensor(init, dtype=dtype, device=dev).reshape(
        (2,) + (1,) * (len(shape) - 1)).expand(shape).clone()
    params.requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr)
    trace = []
    for _ in range(int(steps)):
        opt.zero_grad()
        val = neg_evidence(params)
        val.backward()
        opt.step()
        trace.append(float(val.detach()))
    with torch.no_grad():
        final_neg = float(neg_evidence(params))
    p = params.detach().cpu().numpy().astype(np.float64)
    norms = np.broadcast_to(10.0 ** p[0], (num_layers,)).copy()
    scales = np.broadcast_to(10.0 ** p[1], (num_layers,)).copy()
    return {"norms": norms, "scales": scales,
            "log_marglik": -final_neg - float(nll_sum), "trace": trace}


def log_marginal_likelihood(est, nll_sum: float, add, multiply) -> float:
    """Laplace evidence for the damped posterior precision P(add,
    multiply). ``add`` is the per-layer (or scalar) Gaussian prior
    precision and must be > 0; ``multiply`` scales the curvature (the
    reference's ``pre_scale * scale``, the effective dataset size). A
    damped factor that is not positive definite raises
    ``torch.linalg.LinAlgError`` from its Cholesky."""
    add_l, mult_l = normalize_damping(add, multiply, len(est.metas),
                                      est.device, est.dtype)
    add_np = add_l.detach().cpu().numpy().astype(np.float64)
    if not (add_np > 0).all():
        raise ValueError("marginal likelihood needs prior precision add > 0")
    counts, theta_sq = covered_params(est)
    prior_term = 0.5 * float(
        np.sum(counts * np.log(add_np) - add_np * theta_sq))
    logdet = est.logdet_precision(add_l, mult_l)
    return -float(nll_sum) + prior_term - 0.5 * logdet
