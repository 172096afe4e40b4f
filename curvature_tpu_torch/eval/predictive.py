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
(Immer et al., 2021): one ``torch.func.jvp`` of ``functional_call``
mapped by ``torch.func.vmap`` over the stacked tangents theta_s -
theta*, the MAP forward once per batch, the model in eval mode
(BatchNorm on its running statistics), as JAX vmaps its jvp (:171-192).
The sampled logit ensemble is one vmapped forward too
(``eval/evaluate.py``'s ``make_ensemble_fn``, whose route and layout
rules hold here); the linearized jvp is vmapped for every family that
can run under vmap, at any image size.

Every eval function takes ``ensemble_params=`` (a list of parameter
dicts, as ``Estimator.ensemble_params`` returns, or the members
stacked) so that a caller can
feed a given ensemble; without it ``samples`` members are drawn from
``generator``. Data batches are (model input, labels); a causal LM's
[B, T, V] outputs are scored per token, flattened to [B*T, V] with the
labels to [B*T], as ``eval_bnn`` does. ``mesh`` splits each batch over
the mesh's data axis: each rank runs its rows through every member and
the logits are gathered in batch order (JAX ``_mesh_wrap``, :64-83).
"""
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call, jvp, vmap

from curvature_tpu_torch.eval.evaluate import (
    _batches, _device, _nchw, ensemble_logits, ensemble_size, eval_mode,
    nchw_rest, prepare_ensemble, stack_ensemble, vmaps)
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


def _per_token(logits: torch.Tensor) -> torch.Tensor:
    """Logits at least f32 (a bf16 forward's upcast, a float64 one's
    kept); a causal LM's [B, T, V] as per-token [B*T, V]."""
    if logits.dtype in (torch.bfloat16, torch.float16):
        logits = logits.float()
    return logits.reshape(-1, logits.shape[-1]) if logits.ndim > 2 \
        else logits


def make_logit_ensemble_fn(model, compute_dtype=None, mesh=None):
    """Per-sample logit forward over an ensemble: ``fwd(ensemble_params,
    x)`` -> [S, B, K] logits ([S, B*T, V] for a causal LM; a bf16
    forward's upcast to f32), one vmapped forward over the stacked
    members (``evaluate.make_ensemble_fn``'s call without the softmax,
    routed as it by ``evaluate.vmaps``),
    the model in eval mode, parameters and input in ``compute_dtype``
    where one is given; under ``mesh`` this rank's rows, gathered."""
    def fwd(ensemble_params, x):
        x = cast_input(x, compute_dtype)
        ens = prepare_ensemble(model, ensemble_params, x, compute_dtype)

        def rows(xs):
            with eval_mode(model):
                out = ensemble_logits(model, ens, xs)
            return _per_token(out.flatten(0, 1)).unflatten(
                0, (ensemble_size(ens), -1))
        return gather_rows(mesh, rows, x, dim=1)
    return fwd


def make_linearized_ensemble_fn(model, compute_dtype=None, mesh=None):
    """Linearized-ensemble forward: ``fwd(mean_params, ensemble_params,
    x)`` -> (MAP logits [B, K], logits_s [S, B, K]), logits_s = MAP logits
    + J(x)(theta_s - theta*). One ``torch.func.jvp`` of
    ``functional_call`` at the MAP, vmapped over the stacked tangents
    (JAX linearizes once and vmaps the jvp, :171-192): the primal (the
    MAP forward) is unbatched and runs once per batch. Parameters whose
    tensor every member shares with ``mean_params`` have a zero tangent
    and stay out of the jvp. A family that states no vmap runs one jvp a
    member (``evaluate.vmaps``). bf16 logits come back f32. Under
    ``mesh`` this rank's rows, gathered."""
    def fwd(mean_params: Dict[str, torch.Tensor], ensemble_params, x):
        ens = stack_ensemble(ensemble_params)
        mean = dict(mean_params)
        # a member sharing the MAP tensor moves nothing there
        fixed = {k: mean[k] for k, v in ens.shared.items()
                 if k in mean and v is mean[k]}
        moving = {k: v for k, v in mean.items() if k not in fixed}
        if compute_dtype is not None:
            own = {k: v for k, v in model.named_parameters()
                   if k not in mean}
            fixed = cast_floats(dict(own, **fixed), compute_dtype)
            moving = cast_floats(moving, compute_dtype)
        fixed = {k: _nchw(v) for k, v in fixed.items()}
        moving = {k: _nchw(v) for k, v in moving.items()}
        fixed.update(nchw_rest(model, fixed, moving))
        members = {**ens.shared, **ens.stacked}
        tangents = {k: (_nchw(members[k]).to(v.dtype) - v
                        if k in ens.stacked else
                        (_nchw(members[k]).to(v.dtype) - v).expand(
                            (ens.size,) + v.shape))
                    for k, v in moving.items()}
        x = _nchw(cast_input(x, compute_dtype))

        def rows(xs):
            def f(p):
                return functional_call(model, {**fixed, **p}, (xs,))

            def one(t):
                return jvp(f, (moving,), (t,))
            with eval_mode(model), torch.no_grad():
                if not moving:
                    logits0 = f({})
                    lin = torch.zeros((ens.size,) + logits0.shape,
                                      dtype=logits0.dtype,
                                      device=logits0.device)
                elif vmaps(model):
                    logits0, lin = vmap(one, out_dims=(None, 0))(tangents)
                else:
                    outs = [one({k: v[i] for k, v in tangents.items()})
                            for i in range(ens.size)]
                    logits0 = outs[0][0]
                    lin = torch.stack([o[1] for o in outs])
            logits0 = _per_token(logits0)
            lin = _per_token(lin.flatten(0, 1)).unflatten(0, (ens.size, -1))
            # [1 + S, B, K]: the MAP logits, then each sample's
            return torch.cat([logits0[None], logits0[None] + lin])
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
