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
:class:`~curvature_tpu_torch.parallel.Mesh` on JAX's six axes. Every rank
passes the whole batch (and the whole ``[S, B]`` labels) and captures its
block (estimators/capture.py ``Shard``): its rows of the batch
(``data``), its label draws (``sample``) and its tokens (``seq``: the
token dim of ``[B, T]`` LM inputs of a model whose forward takes a
block of positions, ``splits_tokens`` (GPT-2: its attention all-gathers
keys and values); on other inputs and models every rank runs the whole
forward and each conv layer's Grams take the rank's block of output
rows, the patch-Gram route chosen from the whole shape). The ``model``, ``expert`` and ``tensor``
axes split the parameters (nn/placement.py: ScanBlocks depth, MoE
experts, Dense output columns) and the factor state: each leaf that JAX's
``_state_leaf_spec`` shards exists on a rank only as its block
(:meth:`_carry_plan`), each rank computes only its block (the depth or
expert block of a stacked layer, KFAC's G rows ``g[:, rows]^T g`` of a
column-parallel layer), and invert, sample and ``ensemble_params`` run on
the blocks: ``sample(noise=...)`` takes the whole model's standard
normals (``noise_shapes()``) and uses its block of them, so a sharded
draw equals one process's. :meth:`gathered_state` all-gathers the whole
state. The gradient-moment estimators (Diagonal, Block, EFB) square the
global batch gradient, summed over the data (and token) ranks and
gathered over the sample ranks in the capture; the token-Gram estimator
(KFAC) sums its per-rank factor deltas over the ranks that split tokens
and draws and share a block (never over the block-splitting axes), each
weighted by its share of the tokens. A batch or draw count that does not
divide its axis runs whole on every rank of those axes; a token count
that does not divide ``seq`` drops only ``seq`` (JAX's ``_dispatch`` and
its ``_noseq`` wrappers). Internally drawn labels are drawn as one
process draws them, from the whole batch's logits (gathered over the data
and token ranks) with the caller's generator, and each rank keeps its
block. The Gaussian API (``logdet_precision``, ``quadratic_form``,
``precision_solve``) runs on the gathered state with whole offsets.

Differences from the JAX class, by design:
``update_batches`` is a loop of ``update`` calls rather than a scan, and
there is no Pallas compile-failure fallback (a kernel failure raises).
Random draws take injected numbers: ``update`` takes
``labels``, ``sample`` takes standard-normal ``noise``, since
``jax.random`` and torch streams never agree; without them a
``torch.Generator`` draws.
"""
import contextlib
import dataclasses
import fnmatch
import itertools
import math
from typing import Dict, List, Optional, Sequence, Union

import torch

from curvature_tpu_torch.nn.core import (
    LayerMeta, apply_matrix_delta, param_key, param_matrix)
from curvature_tpu_torch.ops.patches import extract_patches
from curvature_tpu_torch.estimators.capture import Captured, Shard, collect
from curvature_tpu_torch.parallel.mesh import all_gather, all_reduce_tree
from curvature_tpu_torch.utils import monitor
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


def _map_tree(fn, tree, plan):
    """``fn(leaf, spec)`` over a tree and its plan of the same nesting."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, plan[k]) for k, v in tree.items()}
    return fn(tree, plan)


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
    #: whether the capture hands on an MoE expert layer's routed rows
    #: (capture.collect ``routed``) instead of its masked stream
    routed_streams = False

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
        self._snapshot_mean()
        self.state = self.init_state()
        self.inv_state = None
        #: set by use_mesh(); None = one process
        self.mesh = None
        self._data_axis, self._sample_axis, self._seq_axis = \
            "data", None, None
        self._mesh_axes = None
        #: {carry attribute: tree of per-leaf specs} (use_mesh)
        self._plan = None
        self._whole_view = False
        #: the calls of update() so far: the ``step`` of their spans
        self.updates = 0

    def _snapshot_mean(self):
        """MAP mean snapshot of the tracked parameters (the reference's
        deep-copied model_state), keyed like the state dict: under a mesh
        this rank's blocks of them."""
        own = dict(self.model.named_parameters())
        self.mean_params = {
            k: own[k].detach().clone()
            for name in self.metas for k in (param_key(name, "weight"),
                                             param_key(name, "bias"))
            if k in own}

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
    #: whether the estimator shards a column-parallel layer's state rows
    #: (KFAC's G, Diagonal's [out, cols]); the others keep every layer
    #: whole under the tensor axis, since their replicated state needs
    #: every row of every gradient
    shards_tensor_rows = False
    #: whether use_mesh places the model's parameters (nn/placement.py);
    #: the Subspace sketch runs the whole model on every rank
    places_model = True

    def use_mesh(self, mesh, data_axis: str = "data",
                 sample_axis: Optional[str] = "auto",
                 model_axis: Optional[str] = "auto",
                 tensor_axis: Optional[str] = "auto",
                 seq_axis: Optional[str] = "auto",
                 expert_axis: Optional[str] = "auto",
                 tensor_min_out: int = 128):
        """Split factor updates, the parameters and the factor state over
        ``mesh`` (JAX base.py:223-366; the module docstring): the batch over
        ``data_axis``, the label draws over ``sample_axis``, the tokens over
        ``seq_axis``, ScanBlocks depth over ``model_axis``, MoE experts over
        ``expert_axis``, and the output columns of Dense layers with
        ``out_features`` divisible by the axis and ``>= tensor_min_out``
        over ``tensor_axis``. ``"auto"`` enables an axis iff the mesh has
        one of that canonical name; an axis nothing uses raises
        ``ValueError``. The model is sharded in place; call it once per
        model and mesh (a second estimator on the same mesh finds the
        model placed)."""
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
        model_axis = resolve(model_axis, "model")
        tensor_axis = resolve(tensor_axis, "tensor")
        seq_axis = resolve(seq_axis, "seq")
        expert_axis = resolve(expert_axis, "expert")
        unused = set(mesh.shape) - {data_axis, sample_axis, model_axis,
                                    tensor_axis, seq_axis, expert_axis}
        if unused:
            # an axis nothing shards over silently idles its ranks
            raise ValueError(
                f"mesh axes {sorted(unused)} are not used by any sharding "
                "rule; canonical names are data/sample/model/tensor/seq/"
                "expert (or pass the axis explicitly to use_mesh)")
        self.mesh = mesh
        self._data_axis, self._sample_axis = data_axis, sample_axis
        self._seq_axis = seq_axis
        ax = {"model": model_axis, "model_size": mesh.size(model_axis),
              "tensor": tensor_axis, "tensor_size": mesh.size(tensor_axis),
              "expert": expert_axis, "expert_size": mesh.size(expert_axis),
              "tp": (self._tp_layer_names(mesh.size(tensor_axis),
                                          tensor_min_out)
                     if tensor_axis else frozenset())}
        if self.places_model:
            from curvature_tpu_torch.nn.placement import shard_model
            ax["tp"] = shard_model(self.model, mesh, ax)
        else:
            ax["tp"] = frozenset()
        self._mesh_axes = ax
        self._plan = self._carry_plan()
        self._set_carry(self._apply_plan(self._carry(), self._plan,
                                         gather=False))
        self._snapshot_mean()
        # every sum group, made now in one order on every rank
        split = [a for a in (data_axis, sample_axis, seq_axis) if a]
        for n in range(1, len(split) + 1):
            for axes in itertools.combinations(split, n):
                mesh.group_of(axes)
        return self

    # -- the sharding rules (JAX base.py:367-414) -------------------------------
    def _tp_ok(self, name: str, meta: LayerMeta) -> bool:
        """Whether a layer is eligible for column (tensor) parallelism
        (JAX :367-371): a plain dense layer, where the estimator shards
        its state rows (:attr:`shards_tensor_rows`). MoE experts keep their
        columns whole (their forward is the expert stack's)."""
        return (self.shards_tensor_rows and meta.kind == "dense"
                and meta.groups == 1 and not meta.moe)

    def _tp_layer_names(self, axis_size: int, min_out: int):
        return frozenset(
            n for n, m in self.metas.items()
            if self._tp_ok(n, m) and m.out_features % axis_size == 0
            and m.out_features >= min_out)

    def _state_leaf_spec(self, name: str, keys, shape, ax) -> list:
        """The axis of each dim of one factor-state leaf of layer ``name``
        (None: whole); ``keys`` are the dict keys below the layer level.
        Base rule (JAX :379-393): the leading stack axis, ScanBlocks depth
        over the model axis, MoE experts over the expert axis, where it
        divides. Estimators extend it with tensor-parallel dims."""
        m = self.metas.get(name)
        spec = [None] * len(shape)
        if m is not None and m.stacked and shape and shape[0] == m.stacked:
            lead, size = ((ax["expert"], ax["expert_size"])
                          if getattr(m, "moe", False)
                          else (ax["model"], ax["model_size"]))
            if lead and shape[0] % size == 0:
                spec[0] = lead
        return spec

    def _carry(self) -> Dict:
        """The arrays an update carries, by attribute (JAX ``_carry``); EFB
        and INF add theirs."""
        return {"state": self.state}

    def _set_carry(self, carry: Dict):
        for attr, tree in carry.items():
            setattr(self, attr, tree)

    def _tree_plan(self, tree, keys=(), name=None):
        """The spec of every leaf of ``tree`` (JAX ``_carry_shardings``):
        leaves under a tracked layer's key follow
        :meth:`_state_leaf_spec`, the others stay whole."""
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if name is None and k in self.metas:
                    out[k] = self._tree_plan(v, (), k)
                else:
                    out[k] = self._tree_plan(
                        v, keys + ((k,) if name is not None else ()), name)
            return out
        shape = tuple(tree) if isinstance(tree, tuple) else tuple(tree.shape)
        if name is None:
            return [None] * len(shape)
        return self._state_leaf_spec(name, keys, shape, self._mesh_axes)

    def _carry_plan(self) -> Dict:
        return {attr: self._tree_plan(tree)
                for attr, tree in self._carry().items()}

    def _apply_plan(self, tree, plan, gather: bool):
        """Each leaf cut to this rank's block of its planned dims, or
        (``gather``) its blocks all-gathered into the whole."""
        mesh = self.mesh

        def one(t, spec):
            if t is None:
                return t
            for dim, axis in enumerate(spec):
                if axis is None or mesh.size(axis) == 1:
                    continue
                if gather:
                    t = all_gather(t, mesh.group(axis), dim)
                else:
                    sl = mesh.rows(t.shape[dim], axis)
                    t = t.narrow(dim, sl.start, sl.stop - sl.start)
            return t if gather else t.contiguous().clone()
        return _map_tree(one, tree, plan)

    def _sharded(self) -> bool:
        """Whether some leaf of the carry lives split over the ranks."""
        def any_split(plan):
            if isinstance(plan, dict):
                return any(any_split(v) for v in plan.values())
            return any(a is not None and self.mesh.size(a) > 1
                       for a in plan)
        return self._plan is not None and not self._whole_view \
            and any_split(self._plan)

    def gathered_state(self, attr: str = "state"):
        """The whole of a carried tree (``"state"``; EFB's ``"diags"``):
        the planned dims all-gathered over their ranks, on every rank; the
        tree itself where nothing is split."""
        tree = getattr(self, attr)
        if not self._sharded():
            return tree
        return self._apply_plan(tree, self._plan[attr], gather=True)

    def state_plan(self, attr: str = "state") -> Optional[Dict]:
        """The tree of per-leaf axis specs of a carried tree (None without
        a mesh): what ``utils.checkpoint.save_pytree_sharded`` takes."""
        return None if self._plan is None else self._plan[attr]

    @contextlib.contextmanager
    def _whole(self):
        """Run the block with the whole carry in place of this rank's
        blocks (the Gaussian API on a sharded state)."""
        if not self._sharded():
            yield
            return
        saved = self._carry()
        self._set_carry({k: self.gathered_state(k) for k in saved})
        self._whole_view = True
        try:
            yield
        finally:
            self._whole_view = False
            self._set_carry(saved)

    def _tp_rows(self, name: str) -> Optional[slice]:
        """This rank's rows of a column-parallel layer's output features
        (None: the layer is whole here)."""
        ax = self._mesh_axes
        if ax is None or self._whole_view or name not in ax["tp"]:
            return None
        return self.mesh.rows(self.metas[name].out_features, ax["tensor"])

    def _tensor_group(self):
        return self.mesh.group(self._mesh_axes["tensor"])

    def _block_noise(self, noise):
        """This rank's block of whole-model standard normals."""
        if not self._sharded():
            return noise
        shapes = {n: (tuple(v.shape) if torch.is_tensor(v)
                      else {k: tuple(x.shape) for k, x in v.items()})
                  for n, v in noise.items()}
        return self._apply_plan(noise, self._tree_plan(shapes), gather=False)

    def _block_capture(self, cap: Captured) -> Captured:
        """The capture with each depth-sharded stacked layer's inputs and
        probes cut to this rank's depth block (the ScanBlocks forward runs
        every depth; an expert-sharded layer is captured as its block)."""
        if not self._sharded():
            return cap
        acts, probes = dict(cap.acts), dict(cap.probe_grads)
        for name, m in self.metas.items():
            if not m.stacked or m.moe:
                continue
            sl = self.mesh.rows(m.stacked, self._mesh_axes["model"])
            if sl is None or sl.stop - sl.start == m.stacked:
                continue
            if name in acts and acts[name].shape[0] == m.stacked:
                acts[name] = acts[name][sl]
            if name in probes and probes[name].shape[1] == m.stacked:
                probes[name] = probes[name][:, sl]
        return dataclasses.replace(cap, acts=acts, probe_grads=probes)

    def _tokens(self, x) -> Optional[int]:
        """The dim the seq axis splits (JAX x.shape[1]: the token dim of
        [B, T] ids, the leading spatial dim of an image, NCHW here)."""
        if x.ndim < 2:
            return None
        return x.shape[2] if x.ndim == 4 else x.shape[1]

    def _dispatch(self, batch: int, mc: Optional[int] = None,
                  tokens: Optional[int] = None) -> str:
        """Which split an update takes (JAX :457-470): ``"sharded"`` when
        the batch and draw counts divide their axes, ``"noseq"`` when the
        token dim does not divide ``seq`` (only seq is dropped), else
        ``"single"`` (the batch and draws whole on every rank; the
        parameter and state blocks stay)."""
        mesh = self.mesh
        if mesh is not None and batch % mesh.size(self._data_axis) == 0 \
                and (mc is None or mc % mesh.size(self._sample_axis) == 0):
            seq = mesh.size(self._seq_axis)
            if seq == 1 or (tokens is not None and tokens % seq == 0):
                return "sharded"
            return "noseq"
        return "single"

    def _shard(self, x: torch.Tensor, labels, num_samples: int):
        """(x, labels, shard) of this rank's block under the mesh; ``x``
        and ``labels`` unchanged (shard None) without one."""
        mesh = self.mesh
        if mesh is None:
            return x, labels, None
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device)
            if labels.ndim == (2 if self.loss in ("lm", "gaussian") else 1):
                labels = labels[None]
        draws = num_samples if labels is None else labels.shape[0]
        mode = self._dispatch(x.shape[0], draws, self._tokens(x))
        d_ax, s_ax, q_ax = self._data_axis, self._sample_axis, self._seq_axis
        split = {"single": (), "noseq": (d_ax, s_ax),
                 "sharded": (d_ax, s_ax, q_ax)}[mode]
        split = tuple(a for a in split if a and mesh.size(a) > 1)
        rows = (mesh.rows(x.shape[0], d_ax) if d_ax in split
                else slice(0, x.shape[0]))
        samples = (mesh.rows(draws, s_ax) if s_ax in split
                   else slice(0, draws))
        seq_mode, tok = None, None
        if q_ax in split:
            # a model whose forward runs a block of positions says so
            # (models/gpt.py); any other runs whole on every seq rank
            seq_mode = ("tokens" if self.loss == "lm" and x.ndim == 2
                        and getattr(self.model, "splits_tokens", False)
                        else "rows")
        if seq_mode == "tokens":
            tok = mesh.rows(x.shape[1], q_ax)
        if labels is not None:
            labels = labels[samples][:, rows]
            if tok is not None:
                labels = labels[:, :, tok]
        shard = Shard(
            data_group=mesh.group(d_ax) if d_ax in split else None,
            sample_group=mesh.group(s_ax) if s_ax in split else None,
            seq_group=mesh.group(q_ax) if seq_mode == "tokens" else None,
            sum_group=mesh.group_of(split) if split else None,
            batch=x.shape[0],
            tokens=x.shape[1] if self.loss == "lm" and x.ndim == 2 else 1,
            divisor=mesh.size(d_ax if d_ax in split else None)
            * mesh.size(q_ax if q_ax in split else None),
            rows=rows, samples=samples, seq_mode=seq_mode,
            seq_index=mesh.index(q_ax) if seq_mode else 0,
            seq_size=mesh.size(q_ax) if seq_mode else 1,
            token_rows=tok)
        x = x[rows]
        if tok is not None:
            x = x[:, tok]
        return x, labels, shard

    def _reduced_delta(self, cap: Captured):
        """This batch's factor delta summed over the ranks that split the
        tokens and draws of this rank's block, each rank's weighted by its
        token share: the token-Gram factors of a meshed capture."""
        delta = self.update_state(self._zeros(), cap)
        leaves = _leaves(delta)
        if cap.shard.divisor > 1:
            for t in leaves:
                t.div_(cap.shard.divisor)
        all_reduce_tree(leaves, cap.shard.sum_group)
        return delta

    def _zeros(self):
        """A zero state of this rank's block shapes."""
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree)
        return zeros(self.state) if self._sharded() else self.init_state()

    @torch.no_grad()
    def batch_state(self, cap: Captured):
        """This batch's factors alone, in a fresh state: the same on every
        rank of a block for a meshed capture."""
        cap = self._block_capture(cap)
        if cap.shard is None or cap.shard.sum_group is None \
                or self.need_param_grads:
            return self.update_state(self._zeros(), cap)
        return self._reduced_delta(cap)

    # -- stateful API (reference lifecycle) ---------------------------------
    @torch.no_grad()
    def _accumulate(self, cap: Captured):
        cap = self._block_capture(cap)
        if cap.shard is None or cap.shard.sum_group is None \
                or self.need_param_grads:
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
                       shard=shard, routed=self.routed_streams)

    def update(self, x: torch.Tensor, labels=None,
               generator: Optional[torch.Generator] = None,
               num_samples: int = 1):
        """Accumulate factors from one batch. ``labels`` ([B] or [S, B];
        [B, T] or [S, B, T] for ``loss='lm'``; [B, D] or [S, B, D] targets
        for ``loss='gaussian'``, JAX base.py:720-725) give the empirical
        Fisher or injected MC labels; ``None`` draws
        ``num_samples`` labels from the model distribution. Its two phases
        are the spans ``capture`` and ``update_state`` (utils/monitor.py),
        both with this call's number as ``step``."""
        self.updates += 1
        with monitor.span("capture", self.device, step=self.updates):
            cap = self.capture(x, labels, generator, num_samples)
        with monitor.span("update_state", self.device, step=self.updates):
            self._accumulate(cap)
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
        with monitor.span("invert"):
            add, multiply = normalize_damping(add, multiply, len(self.metas),
                                              self.device, self.dtype)
            self.inv_state = self._wrap_inv(
                self.invert_state(self.state, add, multiply))
        return self.inv_state

    @torch.no_grad()
    def logdet_precision(self, add=0.0, multiply=1.0) -> float:
        add, multiply = normalize_damping(add, multiply, len(self.metas),
                                          self.device, self.dtype)
        with self._whole():
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
        with self._whole():
            inv = self._wrap_inv(self.invert_state(self.state, add,
                                                   multiply))
            return self.solve_state(inv, self._as_deltas(deltas))

    @torch.no_grad()
    def quadratic_form(self, deltas, add=0.0, multiply=1.0) -> float:
        add, multiply = normalize_damping(add, multiply, len(self.metas),
                                          self.device, self.dtype)
        with self._whole():
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
        """Standard normals of the whole model's :meth:`noise_shapes`, as
        one process draws them with ``generator``."""
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
        return self.sample_state(self.inv_state,
                                 self._block_noise(self._as_noise(noise)))

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
        with monitor.span("sample", members=num_samples):
            return [self.posterior_params(
                        None if noise is None else noise[i], generator)
                    for i in range(num_samples)]
