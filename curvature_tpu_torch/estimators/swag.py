"""SWA-Gaussian (SWAG) posterior collected from training iterates.

Port of ``curvature_tpu/estimators/swag.py`` (Maddox et al., 2019): the
Gaussian comes from SGD iterates instead of curvature,

    mean  = running average of the collected parameter iterates,
    Sigma = 0.5 * diag(var) + D D^T / (2 (K - 1)),

with ``D`` the deviations of the last ``max_rank`` collected iterates from
the running mean and ``var`` the running second moment's variance.
``collect`` takes one iterate per epoch over the SWA window (``--swag`` in
``pipelines/training.py``); ``ensemble_params`` is the sampling surface
``eval_bnn`` calls on the other estimators, each member a full parameter
dict (state-dict keys) for ``torch.func.functional_call``. The moments are
dicts keyed like the model's parameters, the deviation buffer's entries
``[K, ...]``. :meth:`SWAG.jax_state` and :meth:`SWAG.load_jax_state` move
the state to and from JAX's layout (its state files load in both
packages). Random draws take injected numbers (``noise``), as the other
estimators' samplers do: ``{"z1": {key: z}, "z2": [K]}``.

BatchNorm caveat (standard SWAG practice): sampled and averaged weights
shift the activation statistics, so a model with BatchNorm should
re-estimate its running statistics with :func:`update_batch_stats` before
it is evaluated.
"""
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from curvature_tpu_torch.models.convert import (
    state_dict_from_jax, variables_to_jax)


class SWAG:
    """Collect -> (optional scale) -> sample. ``invert(add, multiply)``
    exists for the pipelines: ``multiply`` scales the sampling covariance
    (SWAG's 0.5 is already folded in; 1.0 is the paper's posterior),
    ``add`` is ignored (there is no damping to invert). There are no
    ``metas``: nothing is tracked per layer."""

    def __init__(self, model: Optional[nn.Module] = None,
                 max_rank: int = 20):
        self.model = model
        self.max_rank = int(max_rank)
        self.n = 0
        self.mean = None         # running first moment
        self.sq_mean = None      # running second moment
        self.dev = None          # [K, ...] deviations (ring buffer)
        self.scale = 1.0
        self.mean_params = None  # set by finalize(): the SWA mean

    # -- collection ---------------------------------------------------------
    @torch.no_grad()
    def collect(self, params):
        """Fold one parameter iterate (a module, or a dict of tensors keyed
        like its state dict) into the running moments and the deviation
        ring buffer."""
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        p = {k: v.detach().float().clone() for k, v in params.items()}
        n = self.n
        if n == 0:
            self.mean = p
            self.sq_mean = {k: a * a for k, a in p.items()}
        else:
            self.mean = {k: (n * self.mean[k] + a) / (n + 1)
                         for k, a in p.items()}
            self.sq_mean = {k: (n * self.sq_mean[k] + a * a) / (n + 1)
                            for k, a in p.items()}
        dev = {k: (a - self.mean[k])[None] for k, a in p.items()}
        if self.dev is None:
            self.dev = dev
        else:
            self.dev = {k: torch.cat([self.dev[k], d])[-self.max_rank:]
                        for k, d in dev.items()}
        self.n = n + 1
        return self

    # -- state ----------------------------------------------------------------
    @property
    def state(self) -> Dict:
        if self.n == 0:
            raise RuntimeError("SWAG state is empty; call collect() first")
        return {"mean": self.mean, "sq_mean": self.sq_mean, "dev": self.dev,
                "n": self.n}

    @state.setter
    def state(self, value: Dict):
        self.mean = value["mean"]
        self.sq_mean = value["sq_mean"]
        self.dev = value["dev"]
        self.n = int(value["n"])
        self.finalize()

    def jax_state(self) -> Dict:
        """The state in JAX's layout (numpy; its ``state`` pytree), for
        ``utils.checkpoint.save_pytree``."""
        s = self.state

        def params(tree, lead=0):
            return variables_to_jax(self.model, tree, lead)["params"]
        return {"mean": params(s["mean"]), "sq_mean": params(s["sq_mean"]),
                "dev": params(s["dev"], lead=1),
                "n": np.asarray(s["n"], np.int32)}

    def load_jax_state(self, tree: Dict, device=None):
        """Set the state from JAX's layout (a loaded state file)."""
        device = device or next(self.model.parameters()).device

        def params(t, lead=0):
            return {k: v.to(device)
                    for k, v in state_dict_from_jax({"params": t},
                                                    lead).items()}
        self.state = {"mean": params(tree["mean"]),
                      "sq_mean": params(tree["sq_mean"]),
                      "dev": params(tree["dev"], lead=1), "n": tree["n"]}
        return self

    def finalize(self):
        """Freeze the SWA mean as the predictive centre."""
        self.mean_params = self.mean
        return self

    # -- the estimators' surface ---------------------------------------------
    def invert(self, add=0.0, multiply=1.0):
        """``multiply`` scales the covariance; ``add`` is ignored."""
        self.scale = float(multiply)
        self.finalize()
        return self

    def noise_shapes(self) -> Dict:
        """Shapes of the standard-normal draws of one sample: ``z1`` one per
        parameter, ``z2`` one per kept deviation."""
        k = next(iter(self.dev.values())).shape[0]
        return {"z1": {key: tuple(v.shape) for key, v in self.mean.items()},
                "z2": (k,)}

    def draw_noise(self, generator: Optional[torch.Generator] = None
                   ) -> Dict:
        device = next(iter(self.mean.values())).device
        shapes = self.noise_shapes()

        def randn(shape):
            return torch.randn(shape, generator=generator, device=device)
        return {"z1": {k: randn(s) for k, s in shapes["z1"].items()},
                "z2": randn(shapes["z2"])}

    @torch.no_grad()
    def posterior_params(self, noise: Optional[Dict] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
        """One draw mean + sqrt(scale) * sqrt(Sigma) z, as a full parameter
        dict: ``sqrt(0.5 var) * z1 + (z2 . D) / sqrt(2 max(K - 1, 1))``
        per parameter (JAX swag.py:108-129)."""
        if self.mean_params is None:
            raise RuntimeError("SWAG is not finalized; call finalize() or "
                               "invert() first")
        if noise is None:
            noise = self.draw_noise(generator)
        k = next(iter(self.dev.values())).shape[0]
        denom = math.sqrt(2.0 * max(k - 1, 1))
        s = math.sqrt(self.scale)
        z2 = torch.as_tensor(noise["z2"], dtype=torch.float32)
        out = {}
        for key, m in self.mean.items():
            var = (self.sq_mean[key] - m * m).clamp_min(0.0)
            z1 = torch.as_tensor(noise["z1"][key], dtype=torch.float32,
                                 device=m.device)
            low_rank = torch.tensordot(z2.to(m.device), self.dev[key],
                                       dims=1) / denom
            out[key] = m + s * (torch.sqrt(0.5 * var) * z1 + low_rank)
        return out

    def ensemble_params(self, num_samples: int,
                        noise: Optional[List[Dict]] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> List[Dict[str, torch.Tensor]]:
        """``num_samples`` posterior parameter dicts (one per draw)."""
        if noise is not None and len(noise) != num_samples:
            raise ValueError(f"{len(noise)} noise draws for {num_samples} "
                             "samples")
        return [self.posterior_params(
                    None if noise is None else noise[i], generator)
                for i in range(num_samples)]


@torch.no_grad()
def update_batch_stats(model: nn.Module, params: Dict[str, torch.Tensor],
                       data, passes: int = 1) -> Dict[str, torch.Tensor]:
    """Re-estimate the BatchNorm running statistics for (averaged or
    sampled) ``params`` by forwarding ``data`` ((model input, labels)
    batches on the model's device) in train mode, standard SWAG practice
    before evaluating a model whose weights moved (JAX swag.py:151-170).
    The model's running statistics seed the estimates and are updated in
    place; its parameters are left as they are. Returns the new
    statistics (buffer name -> tensor)."""
    was_training = model.training
    model.train()
    try:
        for _ in range(passes):
            for x, _ in data:
                functional_call(model, params, (x,))
    finally:
        model.train(was_training)
    return {k: v.clone() for k, v in model.named_buffers()}
