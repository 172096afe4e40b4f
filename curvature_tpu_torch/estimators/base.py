"""Estimator base class: the ``update -> invert -> sample`` lifecycle and
the Gaussian API (``precision_solve``, ``quadratic_form``,
``log_density``).

Port of ``curvature_tpu/estimators/base.py`` for plain and depth-stacked
(ScanBlocks) layers; a stacked layer's state, offsets and samples carry a
leading ``[depth]`` axis. ``loss`` picks the Fisher's output distribution
(``'cross_entropy'``, the per-token ``'lm'``, or unit-variance regression,
``'gaussian'``; estimators/capture.py).
``state`` and ``inv_state`` are dicts keyed by layer name. PyTorch runs
eagerly, so the JAX jitted transforms are plain method calls; the factor
state is updated in place (each ``update`` adds into the existing
tensors instead of allocating a new state).

``compute_dtype`` (e.g. ``torch.bfloat16``) runs the capture forward and
backward with every float parameter and the input cast to it (JAX
``_cast_compute``, base.py:558-565); the model's own parameters and the BN
running buffers are never changed, and the factor state accumulates in
``dtype``.

Differences from the JAX class, by design of this slice: no ``use_mesh``
(ROADMAP Queue 1 item 10, raising ``NotImplementedError``),
``update_batches`` is a loop of ``update`` calls rather than a scan, and
there is no Pallas compile-failure fallback (a kernel failure raises).
Random draws take injected numbers: ``update`` takes
``labels``, ``sample`` takes standard-normal ``noise``, since
``jax.random`` and torch streams never agree; without them a
``torch.Generator`` draws.
"""
import fnmatch
import math
from typing import Dict, List, Optional, Sequence, Union

import torch

from curvature_tpu_torch.nn.core import (
    LayerMeta, apply_matrix_delta, param_key, param_matrix)
from curvature_tpu_torch.ops.patches import extract_patches
from curvature_tpu_torch.estimators.capture import Captured, collect
from curvature_tpu_torch.utils.casting import cast_floats, cast_input

#: reference-compatible layer-type aliases (curvatures.py:57-63)
_TYPE_ALIASES = {
    "Linear": "linear", "Conv2d": "conv", "MultiheadAttention": "attention",
    "linear": "linear", "dense": "linear", "conv": "conv",
    "attention": "attention",
}


def _meta_type(meta: LayerMeta) -> str:
    if meta.kind == "conv":
        return "conv"
    if meta.name.endswith("/in_proj") or meta.name.endswith("/out_proj"):
        return "attention"
    return "linear"


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
               append_ones: bool = False, extra_stride: int = 1,
               offset=(0, 0)) -> torch.Tensor:
    """Layer input (JAX layout) -> [N_tokens, fan_in(+1)]; conv inputs are
    expanded into (c, kh, kw) patches.

    ``extra_stride`` k multiplies the window stride (spatial token
    subsampling: the skipped positions are never generated); ``offset``
    shifts the strided grid in output-grid coordinates. The k^2 offset
    grids partition the positions. A non-zero offset extracts the full
    grid and slices it, as JAX does (base.py:87-97). A grouped conv's
    input does not flatten to one matrix: :func:`grouped_act_tokens`."""
    if meta.kind == "conv":
        if meta.groups > 1:
            raise ValueError(
                f"{meta.name}: grouped conv activations don't flatten to one "
                "[N, fan_in] matrix — use grouped_act_tokens")
        act = _conv_patches(meta, act, extra_stride, offset)
    t = act.reshape(-1, meta.fan_in)
    if append_ones:
        t = torch.cat([t, t.new_ones(t.shape[0], 1)], dim=1)
    return t


def _conv_patches(meta: LayerMeta, act: torch.Tensor, extra_stride: int,
                  offset) -> torch.Tensor:
    """A conv input's [B, H', W', C*kh*kw] patches on the (subsampled)
    output grid."""
    if extra_stride > 1 and tuple(offset) != (0, 0):
        p = extract_patches(act, meta.kernel_size, meta.strides,
                            meta.padding)
        return p[:, offset[0]::extra_stride, offset[1]::extra_stride]
    strides = (meta.strides[0] * extra_stride,
               meta.strides[1] * extra_stride)
    return extract_patches(act, meta.kernel_size, strides, meta.padding)


def grouped_act_tokens(meta: LayerMeta, act: torch.Tensor,
                       append_ones: bool = False, extra_stride: int = 1,
                       offset=(0, 0)) -> torch.Tensor:
    """Grouped-conv input -> [N_tokens, groups, fan_in(+1)] (JAX
    base.py:105-130). Patch features are channel-major (c, kh, kw), so
    channel block j's features are the contiguous slice [j*fan_in,
    (j+1)*fan_in) and one reshape splits the group axis out; the ones
    column (bias) is per group. ``extra_stride`` and ``offset`` subsample
    the output grid as in :func:`act_tokens`."""
    p = _conv_patches(meta, act, extra_stride, offset)
    t = p.reshape(-1, meta.groups, meta.fan_in)
    if append_ones:
        t = torch.cat([t, t.new_ones(t.shape[:-1] + (1,))], dim=-1)
    return t


def is_grouped(meta: LayerMeta) -> bool:
    """A grouped or depthwise conv, whose curvature is block-diagonal over
    its groups."""
    return meta.kind == "conv" and meta.groups > 1


def group_rows(meta: LayerMeta, mat: torch.Tensor) -> torch.Tensor:
    """A grouped conv's [..., out, cols] matrix view as its [..., g,
    out/g, cols] group blocks (output channels are group-major); any other
    layer's as it is."""
    if not is_grouped(meta):
        return mat
    return mat.reshape(mat.shape[:-2] + (meta.groups, -1, mat.shape[-1]))


def ungroup_rows(meta: LayerMeta, blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`group_rows`."""
    if not is_grouped(meta):
        return blocks
    return blocks.reshape(blocks.shape[:-3] + (meta.out_features,
                                               blocks.shape[-1]))


def grad_tokens(meta: LayerMeta, probe_grad: torch.Tensor) -> torch.Tensor:
    """Pre-activation output gradient -> [N_tokens, out]."""
    return probe_grad.reshape(-1, meta.out_features)


def normalize_damping(add, multiply, num_layers: int, device=None,
                      dtype=torch.float32):
    """Scalar or per-layer damping -> two [L] tensors of the state's
    ``dtype`` (a float64 estimator damps in float64)."""
    add = torch.as_tensor(add, dtype=dtype, device=device)
    multiply = torch.as_tensor(multiply, dtype=dtype, device=device)
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

    #: which capture outputs this estimator consumes; subclasses narrow
    #: these so the unused gradient path is never computed (capture.collect)
    need_param_grads = True
    need_probe_grads = True

    def __init__(self, model, dtype=torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 layer_filter: Optional[Union[str, Sequence[str]]] = None,
                 layer_types: Optional[Union[str, Sequence[str]]] = None,
                 loss: str = "cross_entropy"):
        self.model = model
        self.loss = loss
        if layer_types is None:
            wanted = {"linear", "conv", "attention"}
        else:
            if isinstance(layer_types, str):
                layer_types = [layer_types]
            wanted = {_TYPE_ALIASES[t] for t in layer_types}
        metas = {n: m for n, m in model.metas.items()
                 if _meta_type(m) in wanted}
        if not metas:
            raise ValueError("no tracked layers match the requested types")
        self.metas: Dict[str, LayerMeta] = filter_metas(metas, layer_filter)
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.device = next(model.parameters()).device
        # MAP mean snapshot of the tracked parameters (the reference's
        # deep-copied model_state), keyed like the state dict
        own = dict(model.named_parameters())
        self.mean_params = {
            k: own[k].detach().clone()
            for name in self.metas for k in (param_key(name, "weight"),
                                             param_key(name, "bias"))
            if k in own}
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
        layer (a dict of shapes where a layer takes several draws: KFAC's
        head-split ``out_proj``)."""
        raise NotImplementedError

    def logdet_state(self, state, add, multiply):
        """``log det`` of the damped posterior precision the sampler uses,
        summed over the tracked layers."""
        raise NotImplementedError

    def quad_state(self, state, add, multiply, deltas):
        """delta^T P delta for matrix-view offsets ``deltas`` under the
        damped precision P, summed over the tracked layers."""
        raise NotImplementedError

    def solve_state(self, inv_state, deltas):
        """``P^{-1} @ deltas`` (matrix view) with the damped precision the
        sampler draws from, exactly: every sampler is an explicit linear
        square root of P^{-1}."""
        raise NotImplementedError

    # -- inverse-state hooks (EFB carries its eigenvectors) ------------------
    def _inv_aux(self):
        """Arrays ``_wrap_inv`` attaches to the inverse state (EFB: its
        Kronecker eigenvectors; None for the others)."""
        return None

    def _wrap_inv_aux(self, inv, aux):
        return inv

    def _wrap_inv(self, inv):
        return self._wrap_inv_aux(inv, self._inv_aux())

    # -- out of this slice ---------------------------------------------------
    def use_mesh(self, *args, **kwargs):
        raise NotImplementedError(
            "use_mesh and the tensor-parallel leaf specs are not ported yet "
            "(ROADMAP Queue 1 item 10)")

    # -- stateful API (reference lifecycle) ---------------------------------
    @torch.no_grad()
    def _accumulate(self, cap: Captured):
        self.state = self.update_state(self.state, cap)

    def capture(self, x: torch.Tensor, labels=None,
                generator: Optional[torch.Generator] = None,
                num_samples: int = 1) -> Captured:
        """One batch's activations and probe gradients, in
        ``compute_dtype`` where one is set."""
        params = None
        if self.compute_dtype is not None:
            params = cast_floats(dict(self.model.named_parameters()),
                                 self.compute_dtype)
            x = cast_input(x, self.compute_dtype)
        return collect(self.model, self.metas, x, labels=labels,
                       generator=generator, num_samples=num_samples,
                       params=params,
                       need_param_grads=self.need_param_grads,
                       need_probe_grads=self.need_probe_grads,
                       loss=self.loss)

    def update(self, x: torch.Tensor, labels=None,
               generator: Optional[torch.Generator] = None,
               num_samples: int = 1):
        """Accumulate factors from one batch. ``labels`` ([B] or [S, B];
        [B, T] or [S, B, T] for ``loss='lm'``; [B, D] or [S, B, D] targets
        for ``loss='gaussian'``, JAX base.py:720-725) give the empirical
        Fisher or injected MC labels; ``None`` draws
        ``num_samples`` labels from the model distribution."""
        self._accumulate(self.capture(x, labels, generator, num_samples))
        return self.state

    def update_batches(self, xs: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       num_samples: int = 1):
        """Accumulate factors from stacked batches ``xs`` [T, B, ...]: T
        update steps drawing their labels from one ``generator`` (JAX
        base.py:678-703 scans them in one jitted program; here they run one
        after the other, the same steps)."""
        for x in xs:
            self.update(x, generator=generator, num_samples=num_samples)
        return self.state

    @torch.no_grad()
    def invert(self, add=0.0, multiply=1.0):
        """Damped inversion; ``add``/``multiply`` are scalars or per-layer
        sequences."""
        add, multiply = normalize_damping(add, multiply, len(self.metas),
                                          self.device, self.dtype)
        self.inv_state = self._wrap_inv(
            self.invert_state(self.state, add, multiply))
        return self.inv_state

    @torch.no_grad()
    def logdet_precision(self, add=0.0, multiply=1.0) -> float:
        add, multiply = normalize_damping(add, multiply, len(self.metas),
                                          self.device, self.dtype)
        return float(self.logdet_state(self.state, add, multiply))

    def _as_deltas(self, deltas) -> Dict[str, torch.Tensor]:
        return {name: torch.as_tensor(deltas[name], dtype=self.dtype,
                                      device=self.device)
                for name in self.metas}

    @torch.no_grad()
    def precision_solve(self, deltas, add=0.0, multiply=1.0
                        ) -> Dict[str, torch.Tensor]:
        """Damped invert at (add, multiply), then ``P^{-1}`` applied to the
        matrix-view offsets ``deltas`` ({layer: [out, fan_in(+1)]})."""
        add, multiply = normalize_damping(add, multiply, len(self.metas),
                                          self.device, self.dtype)
        inv = self._wrap_inv(self.invert_state(self.state, add, multiply))
        return self.solve_state(inv, self._as_deltas(deltas))

    @torch.no_grad()
    def quadratic_form(self, deltas, add=0.0, multiply=1.0) -> float:
        add, multiply = normalize_damping(add, multiply, len(self.metas),
                                          self.device, self.dtype)
        return float(self.quad_state(self.state, add, multiply,
                                     self._as_deltas(deltas)))

    @torch.no_grad()
    def log_density(self, params: Dict[str, torch.Tensor], add=0.0,
                    multiply=1.0) -> float:
        """Log-density of the Laplace posterior N(theta*, P^-1) at
        ``params`` ({state-dict key: tensor}, as ``posterior_params``
        returns; untracked entries are ignored)."""
        deltas, d = {}, 0
        for name, meta in self.metas.items():
            def mat(p):
                return param_matrix(meta, p[param_key(name, "weight")],
                                    p.get(param_key(name, "bias")))
            deltas[name] = mat(params) - mat(self.mean_params)
            d += deltas[name].numel()
        q = self.quadratic_form(deltas, add, multiply)
        logdet = self.logdet_precision(add, multiply)
        return -0.5 * (q + d * math.log(2 * math.pi)) + 0.5 * logdet

    def draw_noise(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        def draw(shape):
            if isinstance(shape, dict):
                return {k: draw(s) for k, s in shape.items()}
            return torch.randn(shape, generator=generator, dtype=self.dtype,
                               device=self.device)
        return {name: draw(shape)
                for name, shape in self.noise_shapes().items()}

    def _as_noise(self, v):
        if isinstance(v, dict):
            return {k: self._as_noise(x) for k, x in v.items()}
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    @torch.no_grad()
    def sample(self, noise: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        if self.inv_state is None:
            raise RuntimeError("inverse state is empty; call invert() first")
        if noise is None:
            noise = self.draw_noise(generator)
        return self.sample_state(self.inv_state, self._as_noise(noise))

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
