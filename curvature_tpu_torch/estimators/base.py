"""Estimator base class: the ``update -> invert -> sample`` lifecycle.

Port of the plain-layer subset of ``curvature_tpu/estimators/base.py``.
``state`` and ``inv_state`` are dicts keyed by layer name. PyTorch runs
eagerly, so the JAX jitted transforms are plain method calls; the factor
state is updated in place (each ``update`` adds into the existing
tensors instead of allocating a new state).

Differences from the JAX class, by design of this slice: no ``use_mesh``,
no scan over batches, and no Pallas compile-failure fallback (a kernel
failure raises). Random draws take injected numbers: ``update`` takes
``labels``, ``sample`` takes standard-normal ``noise``, since
``jax.random`` and torch streams never agree; without them a
``torch.Generator`` draws.
"""
import fnmatch
from typing import Dict, List, Optional, Sequence, Union

import torch

from curvature_tpu_torch.nn.core import LayerMeta, apply_matrix_delta
from curvature_tpu_torch.ops.patches import extract_patches
from curvature_tpu_torch.estimators.capture import Captured, collect


def filter_metas(metas: Dict[str, LayerMeta], layer_filter) -> Dict:
    """Restrict tracked layers by name: ``"last"`` or ``fnmatch``
    patterns (``"fc*"``, ``"layer3.*"``)."""
    if layer_filter is None:
        return dict(metas)
    if isinstance(layer_filter, str):
        layer_filter = [layer_filter]
    patterns = [p for p in layer_filter if p]
    if patterns == ["last"]:
        last = list(metas)[-1]
        return {last: metas[last]}
    kept = {n: m for n, m in metas.items()
            if any(fnmatch.fnmatch(n, p) for p in patterns)}
    if not kept:
        raise ValueError(
            f"layer_filter {patterns} matches none of {sorted(metas)}")
    return kept


def act_tokens(meta: LayerMeta, act: torch.Tensor,
               append_ones: bool = False) -> torch.Tensor:
    """Layer input (JAX layout) -> [N_tokens, fan_in(+1)]; conv inputs are
    expanded into (c, kh, kw) patches."""
    if meta.kind == "conv":
        act = extract_patches(act, meta.kernel_size, meta.strides,
                              meta.padding)
    t = act.reshape(-1, meta.fan_in)
    if append_ones:
        t = torch.cat([t, t.new_ones(t.shape[0], 1)], dim=1)
    return t


def grad_tokens(meta: LayerMeta, probe_grad: torch.Tensor) -> torch.Tensor:
    """Pre-activation output gradient -> [N_tokens, out]."""
    return probe_grad.reshape(-1, meta.out_features)


def normalize_damping(add, multiply, num_layers: int, device=None):
    """Scalar or per-layer damping -> two [L] float32 tensors."""
    add = torch.as_tensor(add, dtype=torch.float32, device=device)
    multiply = torch.as_tensor(multiply, dtype=torch.float32, device=device)
    if add.ndim == 0:
        add = add.expand(num_layers)
    if multiply.ndim == 0:
        multiply = multiply.expand(num_layers)
    if add.shape[0] != num_layers or multiply.shape[0] != num_layers:
        raise ValueError(
            f"per-layer damping needs {num_layers} entries, got "
            f"{add.shape[0]}/{multiply.shape[0]}")
    return add, multiply


class Estimator:
    """Base class of the curvature estimators."""

    def __init__(self, model, dtype=torch.float32,
                 layer_filter: Optional[Union[str, Sequence[str]]] = None):
        self.model = model
        self.metas: Dict[str, LayerMeta] = filter_metas(model.metas,
                                                        layer_filter)
        self.dtype = dtype
        self.device = next(model.parameters()).device
        # MAP mean snapshot of the tracked parameters (the reference's
        # deep-copied model_state), keyed like the state dict
        own = dict(model.named_parameters())
        self.mean_params = {
            k: own[k].detach().clone()
            for name in self.metas for k in (f"{name}.weight",
                                             f"{name}.bias") if k in own}
        self.state = self.init_state()
        self.inv_state = None

    # -- per-estimator transforms -------------------------------------------
    def init_state(self):
        raise NotImplementedError

    def update_state(self, state, cap: Captured):
        raise NotImplementedError

    def invert_state(self, state, add, multiply):
        raise NotImplementedError

    def sample_state(self, inv_state, noise: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """One posterior offset per layer, {name: [out, fan_in(+1)]}, from
        standard-normal ``noise`` {name: z}."""
        raise NotImplementedError

    def noise_shapes(self) -> Dict[str, tuple]:
        """Shape of the standard-normal draw ``sample_state`` takes per
        layer."""
        raise NotImplementedError

    def logdet_state(self, state, add, multiply):
        raise NotImplementedError

    # -- stateful API (reference lifecycle) ---------------------------------
    @torch.no_grad()
    def _accumulate(self, cap: Captured):
        self.state = self.update_state(self.state, cap)

    def update(self, x: torch.Tensor, labels=None,
               generator: Optional[torch.Generator] = None,
               num_samples: int = 1):
        """Accumulate factors from one batch. ``labels`` ([B] or [S, B])
        give the empirical Fisher or injected MC labels; ``None`` draws
        ``num_samples`` labels from the model distribution."""
        cap = collect(self.model, self.metas, x, labels=labels,
                      generator=generator, num_samples=num_samples)
        self._accumulate(cap)
        return self.state

    @torch.no_grad()
    def invert(self, add=0.0, multiply=1.0):
        """Damped inversion; ``add``/``multiply`` are scalars or per-layer
        sequences."""
        add, multiply = normalize_damping(add, multiply, len(self.metas),
                                          self.device)
        self.inv_state = self.invert_state(self.state, add, multiply)
        return self.inv_state

    def logdet_precision(self, add=0.0, multiply=1.0) -> float:
        add, multiply = normalize_damping(add, multiply, len(self.metas),
                                          self.device)
        return float(self.logdet_state(self.state, add, multiply))

    def draw_noise(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        return {name: torch.randn(shape, generator=generator,
                                  dtype=self.dtype, device=self.device)
                for name, shape in self.noise_shapes().items()}

    @torch.no_grad()
    def sample(self, noise: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        if self.inv_state is None:
            raise RuntimeError("inverse state is empty; call invert() first")
        if noise is None:
            noise = self.draw_noise(generator)
        noise = {k: torch.as_tensor(v, dtype=self.dtype, device=self.device)
                 for k, v in noise.items()}
        return self.sample_state(self.inv_state, noise)

    def posterior_params(self, noise=None, generator=None
                         ) -> Dict[str, torch.Tensor]:
        """MAP parameters + one posterior sample (reference
        ``sample_and_replace``), as a new ``{state-dict key: tensor}``
        dict for ``torch.func.functional_call``."""
        return apply_matrix_delta(self.metas, self.mean_params,
                                  self.sample(noise, generator))

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
