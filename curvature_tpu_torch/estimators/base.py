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

``use_mesh`` splits each update over the ranks of a
:class:`~curvature_tpu_torch.parallel.Mesh`: the batch over its ``data``
axis, the Monte-Carlo label draws over its ``sample`` axis. Every rank
passes the whole batch (and the whole ``[S, B]`` labels) and captures
its block (estimators/capture.py ``Shard``); the factor state stays
replicated. The gradient-moment estimators (Diagonal, Block, EFB) square
the global batch gradient, summed over the data ranks and gathered over
the sample ranks in the capture; the token-Gram estimator (KFAC) sums
its per-rank factor deltas over every rank, each weighted by its share
of the tokens (``1 / data ranks``). A batch or draw count that does not
divide its axis runs whole on every rank, with no collective (JAX's
``_dispatch``). Internally drawn labels are drawn as one process draws
them, from the whole batch's logits (gathered over the data ranks) with
the caller's generator, and each rank keeps its (sample, data) block: the
sample ranks never repeat each other's draws, and a meshed update equals
the single process's for drawn labels too. JAX's model, tensor, seq and
expert axes raise ``NotImplementedError`` (ROADMAP Queue 1 item 10b).

Differences from the JAX class, by design:
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
import torch.distributed as dist

from curvature_tpu_torch.nn.core import (
    LayerMeta, apply_matrix_delta, param_key, param_matrix)
from curvature_tpu_torch.ops.patches import extract_patches
from curvature_tpu_torch.estimators.capture import Captured, Shard, collect
from curvature_tpu_torch.parallel.mesh import (
    all_reduce_tree, later_axes_error)
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


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _add_into(tree, delta):
    """``tree += delta`` leaf by leaf, in place."""
    for k, v in delta.items():
        if isinstance(v, dict):
            _add_into(tree[k], v)
        else:
            tree[k] += v


class Estimator:
    """Base class of the curvature estimators."""

    #: which capture outputs this estimator consumes; subclasses narrow
    #: these so the unused gradient path is never computed (capture.collect)
    need_param_grads = True
    need_probe_grads = True

    @property
    def gram_probe_names(self):
        """Layers whose output-gradient capture is fused into the backward
        as its token Gram (capture.collect); estimators that read only
        that Gram override this (KFAC's ``fused_g``)."""
        return frozenset()

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
        #: set by use_mesh(); None = one process
        self.mesh = None
        self._data_axis, self._sample_axis = "data", None

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

    # -- multi-rank execution -------------------------------------------------
    def use_mesh(self, mesh, data_axis: str = "data",
                 sample_axis: Optional[str] = "auto",
                 model_axis: Optional[str] = "auto",
                 tensor_axis: Optional[str] = "auto",
                 seq_axis: Optional[str] = "auto",
                 expert_axis: Optional[str] = "auto",
                 tensor_min_out: int = 128):
        """Split factor updates over ``mesh`` (JAX base.py:223-366): the
        batch over ``data_axis``, the label draws over ``sample_axis``.
        ``"auto"`` enables an axis iff the mesh has one of that canonical
        name; an axis nothing uses raises ``ValueError``; the model,
        tensor, seq and expert axes (and ``tensor_min_out``, their
        option) raise ``NotImplementedError`` (ROADMAP Queue 1 item
        10b)."""
        def resolve(axis, canonical):
            if axis == "auto":
                return canonical if canonical in mesh.shape else None
            if axis is not None and axis not in mesh.shape:
                raise ValueError(f"mesh {dict(mesh.shape)} has no axis "
                                 f"{axis!r}")
            return axis

        if data_axis not in mesh.shape:
            raise ValueError(f"mesh {dict(mesh.shape)} has no axis "
                             f"{data_axis!r}")
        sample_axis = resolve(sample_axis, "sample")
        later = {a for a in (resolve(model_axis, "model"),
                             resolve(tensor_axis, "tensor"),
                             resolve(seq_axis, "seq"),
                             resolve(expert_axis, "expert")) if a}
        unused = set(mesh.shape) - {data_axis, sample_axis} - later
        if unused:
            # an axis nothing shards over silently idles its ranks
            raise ValueError(
                f"mesh axes {sorted(unused)} are not used by any sharding "
                "rule; canonical names are data/sample/model/tensor/seq/"
                "expert (or pass the axis explicitly to use_mesh)")
        if later:
            raise later_axes_error(later)
        self.mesh = mesh
        self._data_axis, self._sample_axis = data_axis, sample_axis
        return self

    def _shard(self, x: torch.Tensor, labels, num_samples: int):
        """(x, labels, shard) of this rank's block under the mesh; ``x``
        and ``labels`` unchanged (shard None) without one, or when the
        batch or the draw count does not divide its axis."""
        mesh = self.mesh
        if mesh is None:
            return x, labels, None
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device)
            if labels.ndim == (2 if self.loss in ("lm", "gaussian") else 1):
                labels = labels[None]
        draws = num_samples if labels is None else labels.shape[0]
        rows = mesh.rows(x.shape[0], self._data_axis)
        samples = mesh.rows(draws, self._sample_axis)
        if rows is None or samples is None:
            return x, labels, None
        if labels is not None:
            labels = labels[samples][:, rows]
        shard = Shard(
            data_group=mesh.group(self._data_axis),
            sample_group=mesh.group(self._sample_axis),
            world_group=dist.group.WORLD if dist.is_initialized() else None,
            batch=x.shape[0], data_size=mesh.size(self._data_axis),
            rows=rows, samples=samples)
        return x[rows], labels, shard

    def _reduced_delta(self, cap: Captured):
        """This batch's factor delta summed over every rank, each rank's
        weighted by its token share (1 / data ranks): the token-Gram
        factors of a meshed capture."""
        delta = self.update_state(self.init_state(), cap)
        leaves = _leaves(delta)
        if cap.shard.data_size > 1:
            for t in leaves:
                t.div_(cap.shard.data_size)
        all_reduce_tree(leaves, cap.shard.world_group)
        return delta

    @torch.no_grad()
    def batch_state(self, cap: Captured):
        """This batch's factors alone, in a fresh state: the same on every
        rank for a meshed capture."""
        if cap.shard is None or self.need_param_grads:
            return self.update_state(self.init_state(), cap)
        return self._reduced_delta(cap)

    # -- stateful API (reference lifecycle) ---------------------------------
    @torch.no_grad()
    def _accumulate(self, cap: Captured):
        if cap.shard is None or self.need_param_grads:
            # a meshed capture's parameter gradients are already global
            self.state = self.update_state(self.state, cap)
            return
        _add_into(self.state, self._reduced_delta(cap))

    def capture(self, x: torch.Tensor, labels=None,
                generator: Optional[torch.Generator] = None,
                num_samples: int = 1) -> Captured:
        """One batch's activations and probe gradients, in
        ``compute_dtype`` where one is set; under a mesh, this rank's
        block of them (:meth:`use_mesh`)."""
        x, labels, shard = self._shard(x, labels, num_samples)
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
                       loss=self.loss,
                       gram_probe_names=self.gram_probe_names,
                       shard=shard)

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
