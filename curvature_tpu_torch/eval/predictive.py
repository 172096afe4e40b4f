"""Closed-form and linearized Laplace predictives.

Port of ``curvature_tpu/eval/predictive.py``. Two closed-form predictives
act on the Gaussian over *logits* that the weight posterior induces, its
moments estimated from the sampled logit ensemble (no extra forwards):

* probit mean-field: E[softmax(z)] ~ softmax(mu / sqrt(1 + pi/8 * var));
* Laplace bridge: N(mu, var) on the logits mapped to a Dirichlet(alpha)
  (Hobbhahn et al., 2022), predictive mean alpha / sum(alpha), computed
  in log space.

The linearized (GLM) predictive pushes the posterior samples through the
network linearized at the MAP, f(x, theta*) + J(x)(theta_s - theta*)
(Immer et al., 2021): one ``torch.func.jvp`` of ``functional_call`` per
sample, the model in eval mode (BatchNorm on its running statistics).

Every eval function takes ``ensemble_params=`` (a list of parameter
dicts, as ``Estimator.ensemble_params`` returns) so that a caller can
feed a given ensemble; without it ``samples`` members are drawn from
``generator``. Data batches are (model input, labels); a causal LM's
[B, T, V] outputs are scored per token, flattened to [B*T, V] with the
labels to [B*T], as ``eval_bnn`` does. ``mesh`` splits each batch over
the mesh's data axis: each rank runs its rows through every member and
the logits are gathered in batch order (JAX ``_mesh_wrap``, :64-83).
"""
import contextlib
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call, jvp

from curvature_tpu_torch.eval.evaluate import _batches, _device
from curvature_tpu_torch.parallel.mesh import gather_rows
from curvature_tpu_torch.utils.casting import cast_floats, cast_input


def probit_mean_field(mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Mean-field probit-approximate predictive: [..., K] probabilities."""
    kappa = 1.0 / torch.sqrt(1.0 + (math.pi / 8.0) * var)
    return torch.softmax(kappa * mu, dim=-1)


def laplace_bridge(mu: torch.Tensor, var: torch.Tensor, eps: float = 1e-8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian on logits -> Dirichlet(alpha); returns (alpha, mean probs).

    The inputs are standardized by the mean total variance, the paper's
    recipe. The mean is computed in log space: exp(mu_k) * sum_j
    exp(-mu_j) overflows f32 once |mu| / scale passes ~88, which a
    near-zero logit variance guarantees; a softmax over log alpha gives
    the same mean. alpha itself may be inf there (JAX :36-61).
    """
    k = mu.shape[-1]
    scale = torch.sqrt(var.sum(-1, keepdim=True) / (k / 2.0) + eps)
    mu = mu / scale
    var = torch.clamp_min(var / (scale * scale), eps)
    log_cross = mu + torch.logsumexp(-mu, dim=-1, keepdim=True) \
        - 2.0 * math.log(float(k))
    floor = math.log(1.0 - 2.0 / k) if k > 2 else -math.inf
    log_alpha = torch.logaddexp(torch.full_like(log_cross, floor),
                                log_cross) - torch.log(var)
    return torch.exp(log_alpha), torch.softmax(log_alpha, dim=-1)


def moments(logits_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and (population) variance over the sample axis 0."""
    return logits_s.mean(0), logits_s.var(0, correction=0)


@contextlib.contextmanager
def eval_mode(model):
    """The model in eval mode for the block, its mode restored after."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def _per_token(logits: torch.Tensor) -> torch.Tensor:
    """Logits at least f32 (a bf16 forward's upcast, a float64 one's
    kept); a causal LM's [B, T, V] as per-token [B*T, V]."""
    if logits.dtype in (torch.bfloat16, torch.float16):
        logits = logits.float()
    return logits.reshape(-1, logits.shape[-1]) if logits.ndim > 2 \
        else logits


def _base(model, compute_dtype) -> Dict[str, torch.Tensor]:
    """The model's own parameters cast to ``compute_dtype``, empty without
    one (``functional_call`` then takes the module's). Buffers stay as
    they are: BatchNorm normalizes in f32 on f32 running statistics, as
    JAX keeps ``batch_stats`` f32."""
    if compute_dtype is None:
        return {}
    return cast_floats(dict(model.named_parameters()), compute_dtype)


def make_logit_ensemble_fn(model, compute_dtype=None, mesh=None):
    """Per-sample logit forward over an ensemble: ``fwd(ensemble_params,
    x)`` -> [S, B, K] logits ([S, B*T, V] for a causal LM; a bf16
    forward's upcast to f32), the model in eval mode, parameters and
    input in ``compute_dtype`` where one is given; under ``mesh`` this
    rank's rows, gathered."""
    def fwd(ensemble_params: List[Dict[str, torch.Tensor]], x):
        base = _base(model, compute_dtype)
        x = cast_input(x, compute_dtype)

        def rows(xs):
            with eval_mode(model), torch.no_grad():
                outs = [functional_call(
                    model, {**base, **cast_floats(p, compute_dtype)}, (xs,))
                    for p in ensemble_params]
            return torch.stack([_per_token(o) for o in outs])
        return gather_rows(mesh, rows, x, dim=1)
    return fwd


def make_linearized_ensemble_fn(model, compute_dtype=None, mesh=None):
    """Linearized-ensemble forward: ``fwd(mean_params, ensemble_params,
    x)`` -> (MAP logits [B, K], logits_s [S, B, K]), logits_s = MAP logits
    + J(x)(theta_s - theta*). The MAP forward runs once per batch; each
    sample is one forward-mode ``jvp`` of ``functional_call`` (JAX
    linearizes once and vmaps the jvp, :171-192). bf16 logits come back
    f32. Under ``mesh`` this rank's rows, gathered."""
    def fwd(mean_params: Dict[str, torch.Tensor],
            ensemble_params: List[Dict[str, torch.Tensor]], x):
        base = _base(model, compute_dtype)
        x = cast_input(x, compute_dtype)
        mean = cast_floats(mean_params, compute_dtype)

        def rows(xs):
            def f(p):
                return functional_call(model, {**base, **p}, (xs,))
            with eval_mode(model), torch.no_grad():
                logits0 = _per_token(f(mean))
                lin = []
                for e in ensemble_params:
                    e = cast_floats(e, compute_dtype)
                    tangent = {k: e[k] - mean[k].to(e[k].dtype)
                               for k in mean}
                    lin.append(_per_token(jvp(f, (mean,), (tangent,))[1]))
            # [1 + S, B, K]: the MAP logits, then each sample's
            return torch.cat([logits0[None], logits0[None]
                              + torch.stack(lin)])
        out = gather_rows(mesh, rows, x, dim=1)
        return out[0], out[1:]
    return fwd


def _ensemble(estimator, samples, ensemble_params, generator):
    if ensemble_params is not None:
        return ensemble_params
    return estimator.ensemble_params(samples, generator=generator)


def eval_bnn_closed_form(model, estimator, data: Iterable, samples: int = 30,
                         ensemble_params: Optional[List[Dict]] = None,
                         generator: Optional[torch.Generator] = None,
                         method: str = "probit", mesh=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form Bayesian predictive from the sampled logit ensemble:
    the same ensemble forwards as ``eval_bnn``, keeping logits, their
    per-input mean and variance through ``method`` ('probit' or
    'bridge'). Returns (predictions [N, K], labels [N])."""
    if method not in ("probit", "bridge"):
        raise ValueError(f"unknown closed-form method {method!r}")
    ensemble = _ensemble(estimator, samples, ensemble_params, generator)
    fwd = make_logit_ensemble_fn(model, mesh=mesh)
    preds, labels = [], []
    for x, y in _batches(data, _device(model)):
        mu, var = moments(fwd(ensemble, x))
        p = probit_mean_field(mu, var) if method == "probit" \
            else laplace_bridge(mu, var)[1]
        preds.append(p.cpu().numpy())
        labels.append(y)
    return np.concatenate(preds), np.concatenate(labels)


def eval_bnn_regression(model, estimator, data: Iterable, samples: int = 30,
                        ensemble_params: Optional[List[Dict]] = None,
                        generator: Optional[torch.Generator] = None,
                        linearized: bool = True, noise_var: float = 1.0,
                        mesh=None):
    """Bayesian regression predictive: (mean [N, D], variance [N, D],
    targets [N, D]). The epistemic variance is the ensemble variance of
    the outputs, through the MAP-linearized network by default; the
    returned variance adds the observation noise ``noise_var`` (the
    unit-variance Fisher of ``loss='gaussian'``)."""
    ensemble = _ensemble(estimator, samples, ensemble_params, generator)
    if linearized:
        lin = make_linearized_ensemble_fn(model, mesh=mesh)

        def fwd(x):
            return lin(estimator.mean_params, ensemble, x)[1]
    else:
        raw = make_logit_ensemble_fn(model, mesh=mesh)

        def fwd(x):
            return raw(ensemble, x)
    device = _device(model)
    means, variances, labels = [], [], []
    for x, y in data:
        mu, var = moments(fwd(torch.as_tensor(x, device=device)))
        means.append(mu.cpu().numpy())
        variances.append((var + noise_var).cpu().numpy())
        labels.append(np.asarray(y))
    return (np.concatenate(means), np.concatenate(variances),
            np.concatenate(labels))


def eval_bnn_linearized(model, estimator, data: Iterable, samples: int = 30,
                        ensemble_params: Optional[List[Dict]] = None,
                        generator: Optional[torch.Generator] = None,
                        method: str = "mc", mesh=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Linearized-Laplace (GLM) predictive (Immer et al., 2021):
    ``method`` 'mc' averages the softmax over the linearized logit
    samples; 'probit' / 'bridge' apply the closed forms to the MAP logits
    and the linearized samples' variance. Returns (predictions [N, K],
    labels [N])."""
    if method not in ("mc", "probit", "bridge"):
        raise ValueError(f"unknown linearized method {method!r}")
    ensemble = _ensemble(estimator, samples, ensemble_params, generator)
    fwd = make_linearized_ensemble_fn(model, mesh=mesh)
    preds, labels = [], []
    for x, y in _batches(data, _device(model)):
        logits0, logits_s = fwd(estimator.mean_params, ensemble, x)
        preds.append(linearized_probs(logits0, logits_s, method)
                     .cpu().numpy())
        labels.append(y)
    return np.concatenate(preds), np.concatenate(labels)


def linearized_probs(logits0: torch.Tensor, logits_s: torch.Tensor,
                     method: str) -> torch.Tensor:
    """[B, K] probabilities of linearized logits: the MC mean softmax
    ('mc'), or a closed form around the MAP logits with the samples'
    variance ('probit' / 'bridge')."""
    if method == "mc":
        return torch.softmax(logits_s, dim=-1).mean(0)
    var = logits_s.var(0, correction=0)
    if method == "probit":
        return probit_mean_field(logits0, var)
    return laplace_bridge(logits0, var)[1]
