"""High-level Laplace facade: fit -> tune -> predict in three calls.

Port of ``curvature_tpu/laplace.py``, the ergonomics of the laplace-torch
package (``Laplace(model, ...); la.fit(loader);
la.optimize_prior_precision(); la(x)``) on this package's estimators::

    from curvature_tpu_torch import laplace
    la = laplace.fit(model, train_batches, estimator="kfac", subset="last",
                     generator=torch.Generator(device).manual_seed(0))
    la.optimize_prior_precision()            # evidence gradient ascent
    probs = la.predictive(x, method="linearized")

Everything delegates to the toolbox: ``estimators``, ``eval/marglik.py``
(evidence and its gradient tuning), ``eval/predictive.py`` (GLM and
closed-form predictives). Batches are (model input, labels) pairs; the
estimator stays reachable as ``la.estimator``.
"""
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from curvature_tpu_torch import estimators as E
from curvature_tpu_torch.eval.marglik import (
    dataset_map_nll, log_marginal_likelihood, marglik_gradient_tune)
from curvature_tpu_torch.eval.predictive import (
    laplace_bridge, linearized_probs, make_linearized_ensemble_fn,
    make_logit_ensemble_fn, moments, probit_mean_field)

METHODS = ("sampled", "probit", "bridge", "linearized", "linearized_probit",
           "linearized_bridge")


class Laplace:
    def __init__(self, model, estimator, train_data=None,
                 pre_scale: float = 1.0):
        self.model = model
        self.estimator = estimator
        self.pre_scale = float(pre_scale)
        self._train_data = train_data
        self._nll = None
        self.norms = None           # tuned per-layer prior precisions
        self.scales = None          # tuned per-layer curvature scales
        self._ens_cache: Dict = {}
        self._fwd = {"logit": make_logit_ensemble_fn(model),
                     "lin": make_linearized_ensemble_fn(model)}

    # -- evidence -------------------------------------------------------------
    def map_nll(self) -> float:
        """Summed MAP NLL over the fit data (cached; constant in the
        damping)."""
        if self._nll is None:
            if self._train_data is None:
                raise ValueError("no train_data was given to fit()")
            self._nll = dataset_map_nll(
                self.model, self._train_data,
                loss=getattr(self.estimator, "loss", "cross_entropy"))
        return self._nll

    def log_marginal_likelihood(self, add=None, multiply=None) -> float:
        """Evidence at (add, multiply), by default the TUNED damping with
        the pre_scale factor the tuner and ``invert`` applied
        (``multiply`` is the full curvature scale: pass pre_scale * scale
        when giving it)."""
        add = self.norms if add is None else add
        if multiply is None and self.scales is not None:
            multiply = self.pre_scale * self.scales
        if add is None or multiply is None:
            raise ValueError("pass (add, multiply) or run "
                             "optimize_prior_precision() first")
        return log_marginal_likelihood(self.estimator, self.map_nll(),
                                       add, multiply)

    def optimize_prior_precision(self, method: str = "marglik",
                                 steps: int = 200, lr: float = 0.1,
                                 per_layer: bool = False) -> Dict:
        """Tune the damping (``marglik``: evidence gradient ascent, no
        eval pass); the tuned values are kept, and the estimator inverted
        at them for :meth:`predictive`."""
        if method != "marglik":
            raise ValueError("only method='marglik' is supported here; use "
                             "pipelines.hyper for validation-cost BayesOpt")
        res = marglik_gradient_tune(self.estimator, self.map_nll(),
                                    steps=steps, lr=lr,
                                    pre_scale=self.pre_scale,
                                    per_layer=per_layer)
        self.norms, self.scales = res["norms"], res["scales"]
        self.estimator.invert(self.norms, self.pre_scale * self.scales)
        return res

    # -- prediction -----------------------------------------------------------
    def _ensemble(self, samples, generator, noise) -> List[Dict]:
        """The drawn ensemble, cached on the instance for per-batch
        serving: redrawn when the sample count, the seed state of the
        generator or the inverse state (a new damping) change."""
        key = (samples, None if generator is None
               else bytes(generator.get_state().cpu().numpy()),
               None if noise is None else id(noise))
        if self._ens_cache.get("key") != key or \
                self._ens_cache.get("inv") is not self.estimator.inv_state:
            self._ens_cache = {
                "key": key, "inv": self.estimator.inv_state,
                "ens": self.estimator.ensemble_params(
                    samples, noise=noise, generator=generator)}
        return self._ens_cache["ens"]

    def predictive(self, x, method: str = "sampled", samples: int = 30,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[List[Dict]] = None) -> np.ndarray:
        """Posterior predictive probabilities [B, K] for one batch.

        ``method``: 'sampled' (the MC push-through, the reference's) |
        'probit' | 'bridge' (closed forms on the sampled logits' moments)
        | 'linearized' (GLM), 'linearized_probit', 'linearized_bridge'.
        The draws come from ``generator`` (a fresh one seeded 0 by
        default) or from the standard-normal ``noise`` given."""
        if self.estimator.inv_state is None:
            raise ValueError("invert first: optimize_prior_precision() or "
                             "estimator.invert(add, multiply)")
        if method not in METHODS:
            raise ValueError(f"unknown predictive method {method!r}")
        device = self.estimator.device
        if generator is None and noise is None:
            generator = torch.Generator(device=device).manual_seed(0)
        ens = self._ensemble(samples, generator, noise)
        x = torch.as_tensor(x, device=device)
        if method.startswith("linearized"):
            logits0, logits_s = self._fwd["lin"](self.estimator.mean_params,
                                                 ens, x)
            sub = method[len("linearized"):].lstrip("_") or "mc"
            probs = linearized_probs(logits0, logits_s, sub)
        else:
            logits_s = self._fwd["logit"](ens, x)
            if method == "sampled":
                probs = torch.softmax(logits_s, dim=-1).mean(0)
            else:
                mu, var = moments(logits_s)
                probs = probit_mean_field(mu, var) if method == "probit" \
                    else laplace_bridge(mu, var)[1]
        return probs.cpu().numpy()

    __call__ = predictive


def fit(model, train_data: Iterable, estimator: str = "kfac", subset=None,
        mc_samples: int = 10, generator: Optional[torch.Generator] = None,
        pre_scale: float = 1.0, **est_kwargs) -> Laplace:
    """Build an estimator, accumulate its Fisher over ``train_data`` and
    return a :class:`Laplace` handle.

    ``subset``: a ``layer_filter`` ('last' or fnmatch patterns) for
    subnetwork Laplace. ``estimator``: diag | kfac | block | subspace
    (alias lowrank; ``rank`` is its sketch width) | efb | inf (EFB and INF fit their prerequisites first, one pass each, in the
    reference's factors order). The MC labels are drawn from
    ``generator`` (seeded 0 by default); every pass restarts it, as JAX
    restarts its key.
    """
    train_data = list(train_data)
    device = next(model.parameters()).device
    seed_state = (generator if generator is not None else torch.Generator(
        device=device).manual_seed(0)).get_state()

    def run_updates(est):
        gen = torch.Generator(device=device)
        gen.set_state(seed_state)
        for x, _ in train_data:
            est.update(torch.as_tensor(x, device=device), generator=gen,
                       num_samples=mc_samples)
        return est

    name = estimator.lower()
    rank = est_kwargs.pop("rank", 100)
    kw = dict(layer_filter=subset, **est_kwargs)
    if name == "diag":
        est = run_updates(E.Diagonal(model, **kw))
    elif name == "block":
        est = run_updates(E.BlockDiagonal(model, **kw))
    elif name == "kfac":
        est = run_updates(E.KFAC(model, **kw))
    elif name in ("subspace", "lowrank"):
        # the global low-rank Nystrom Laplace (estimators/subspace.py);
        # ``rank`` is the sketch width
        est = run_updates(E.Subspace(model, rank=rank, **kw))
    elif name in ("efb", "inf"):
        kfac = run_updates(E.KFAC(model, layer_filter=subset))
        efb = run_updates(E.EFB(model, kfac.state, **kw))
        if name == "efb":
            est = efb
        else:
            diag = run_updates(E.Diagonal(model, layer_filter=subset))
            est = E.INF(model, diag.state, kfac.state, efb.state,
                        eigvecs=efb.eigvecs, layer_filter=subset)
            est.update(rank=rank)
    else:
        raise ValueError(f"unknown estimator {estimator!r}")
    return Laplace(model, est, train_data, pre_scale=pre_scale)
