"""Device meshes over ``torch.distributed`` ranks, and the collectives the
port runs on them.

Port of ``curvature_tpu/parallel/mesh.py`` with JAX's six canonical
axes: ``data`` (the batch split over ranks), ``sample`` (Monte-Carlo label
draws and posterior samples), ``seq`` (the token or image-row dim),
``model`` (ScanBlocks depth), ``tensor`` (Dense output columns) and
``expert`` (MoE experts). A :class:`Mesh` lays its named axes row-major
over the launched world (``"sample:2,data:4"``: rank = 4 * sample index +
data index) and holds one process group per axis: the ranks that differ
only in that axis's index (:meth:`Mesh.group_of` makes one for a set of
axes). JAX gets the global program from GSPMD; here every rank runs its
own block and the results meet in these collectives, which run where the
tensors are (NCCL or gloo on the card, gloo on the CPU;
``parallel.initialize`` picks the backend).

The differentiable collectives are the four of a column- or
expert-parallel layer and of a split token dim:
:func:`gather_replicated` (all-gather; the backward keeps this rank's
block, for a result every rank of the group uses alike),
:func:`gather_partial` (all-gather; the backward is a reduce-scatter, for
a result each rank uses for its own tokens), :func:`copy_to_group`
(identity; the backward sums over the group) and
:func:`reduce_from_group` (a sum; the backward is the identity).

A collective that fails raises; no rank carries on alone. Without an
initialized process group a mesh has one rank and every collective here
is the identity.
"""
import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

#: the canonical axes (JAX ``use_mesh``)
AXES = ("data", "sample", "model", "tensor", "seq", "expert")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def check_size(axis_sizes: Dict[str, int]):
    """Raise ``ValueError`` unless the sizes' product is the world size."""
    world = world_size()
    if math.prod(axis_sizes.values()) != world:
        raise ValueError(f"mesh {dict(axis_sizes)} != {world} ranks")


class Mesh:
    """Named axes with sizes over every rank of the launched world.

    ``shape`` maps axis name to size (JAX's ``mesh.shape``), ``coords``
    this rank's index on each axis. ``group(axis)`` is the process group
    of this rank's line along ``axis``: the default group where the axis
    spans the world, None where it has one rank or no process group is
    up (the collectives then do nothing)."""

    def __init__(self, axis_sizes: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in axis_sizes.items()}
        self.axis_names = tuple(self.shape)
        check_size(self.shape)
        world = world_size()
        self.rank = world_rank()
        rem, coords = self.rank, {}
        for name in reversed(self.axis_names):
            coords[name] = rem % self.shape[name]
            rem //= self.shape[name]
        self.coords = {name: coords[name] for name in self.axis_names}
        self._groups = {}
        if dist.is_initialized():
            for axis in self.axis_names:
                self._groups[(axis,)] = self._make_group((axis,), world)

    def _lines(self, axes) -> List[List[int]]:
        """Every set of ranks that differ only in ``axes``, each in rank
        order (for one axis: its index order), in a fixed order."""
        sizes = [self.shape[a] for a in self.axis_names]
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        lines = {}
        for r in range(math.prod(sizes)):
            key = r
            for a in axes:
                i = self.axis_names.index(a)
                key -= ((r // strides[i]) % sizes[i]) * strides[i]
            lines.setdefault(key, []).append(r)
        return [lines[k] for k in sorted(lines)]

    def _make_group(self, axes, world: int):
        size = math.prod(self.shape[a] for a in axes)
        if size == world:
            return dist.group.WORLD
        if size == 1:
            return None
        mine = None
        # every rank creates every group, in the same order
        for ranks in self._lines(axes):
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def group_of(self, axes):
        """The process group of the ranks that differ only in ``axes``
        (names of this mesh; None entries are skipped): None where they
        span one rank. A new set is made on first use, so every rank asks
        for the same sets in the same order (``Estimator.use_mesh`` does)."""
        key = tuple(a for a in self.axis_names if a in set(axes))
        if not dist.is_initialized():
            return None
        if key not in self._groups:
            self._groups[key] = self._make_group(key, world_size())
        return self._groups[key]

    def size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def index(self, axis: Optional[str]) -> int:
        return self.coords.get(axis, 0) if axis else 0

    def group(self, axis: Optional[str]):
        return self._groups.get((axis,)) if axis else None

    def rows(self, n: int, axis: Optional[str] = "data") -> Optional[slice]:
        """This rank's block of ``n`` rows split over ``axis``; None when
        ``n`` does not divide (the caller then runs every row)."""
        size = self.size(axis)
        if n % size:
            return None
        per = n // size
        start = per * self.index(axis)
        return slice(start, start + per)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over the launched world; the default puts every rank on one
    ``data`` axis. Sizes whose product is not the world size raise
    ``ValueError``."""
    if axis_sizes is None:
        axis_sizes = {"data": world_size()}
    return Mesh(axis_sizes)


def parse_spec(spec: str) -> Dict[str, int]:
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        name, sep, size = part.partition(":")
        if not sep or not name.strip():
            raise ValueError(
                f"bad mesh spec {spec!r}: expected 'name:size[,name:size]'")
        axes[name.strip()] = int(size)
    return axes


def mesh_from_spec(spec: str) -> Mesh:
    """Parse an axis spec like ``"data:8"`` or ``"sample:2,data:4"``."""
    return make_mesh(parse_spec(spec))


def cli_axes(cfg) -> Optional[Dict[str, int]]:
    """The axes of the CLIs' ``--mesh`` spec, checked (None under
    ``--parallel`` alone: every rank on ``data``). A name outside the six
    canonical axes raises ``ValueError``, as JAX's ``use_mesh`` does."""
    spec = getattr(cfg, "mesh", "")
    if not spec:
        return None
    axes = parse_spec(spec)
    unknown = set(axes) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not used by any "
                         f"sharding rule; the axes are {', '.join(AXES)}")
    return axes


def build_mesh(cfg) -> Optional[Mesh]:
    """The pipeline CLIs' mesh from the config: ``--mesh`` (an axis spec,
    :func:`cli_axes`) or ``--parallel`` (every rank on one ``data`` axis);
    None when neither is set. The process group is started before it
    (``utils.config.setup`` does so for the CLIs)."""
    if not getattr(cfg, "mesh", "") and not getattr(cfg, "parallel", False):
        return None
    return make_mesh(cli_axes(cfg))


# -- collectives --------------------------------------------------------------
def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_tree(tensors: List[torch.Tensor], group):
    """Sum a list of same-dtype tensors over ``group`` in place, through
    one flat buffer (one collective)."""
    if group is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (the axis index); ``t`` itself without a group."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """Differentiable sum over a group: the backward sums the cotangents
    over the same group, so every rank's inputs get the gradient of the
    sum of every rank's loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Out-of-place differentiable sum of ``t`` over ``group``."""
    return t if group is None else _AllReduceSum.apply(t, group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over ``group``
    (``t`` itself without a group): an all-reduce and the block, one path
    for every backend (gloo has no reduce-scatter)."""
    if group is None:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return _block(t, group, dim)


def _block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    per = t.shape[dim] // group_size(group)
    return t.narrow(dim, group_rank(group) * per, per).contiguous()


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _block(ct, ctx.group, ctx.dim), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter(ct, ctx.group, ctx.dim).contiguous(), None, \
            None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def gather_replicated(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``, differentiably, for
    a result every rank of the group uses alike (a column-parallel
    output, a depth-sharded stack): the backward keeps this rank's block
    of the cotangent."""
    return t if group is None else _GatherReplicated.apply(t, group, dim)


def gather_partial(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``, differentiably, for
    a result each rank uses for its own part of the loss (the keys and
    values of a split token dim): the backward sums the cotangents over
    the group and keeps this rank's block (a reduce-scatter)."""
    return t if group is None else _GatherPartial.apply(t, group, dim)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """The identity, whose backward sums the cotangents over the group:
    the input of a layer whose ranks each compute a part of its output
    from the whole input (column-parallel Dense, expert-parallel MoE)."""
    return t if group is None else _CopyToGroup.apply(t, group)


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, whose backward is the identity: the partial
    outputs of the ranks of an expert-parallel MoE meeting in a result
    every rank uses alike."""
    return t if group is None else _ReduceFromGroup.apply(t, group)


def gather_rows(mesh: Optional[Mesh], fn, x: torch.Tensor, dim: int = 0,
                axis: str = "data"):
    """``fn`` over this rank's rows of ``x``, the results gathered along
    ``dim`` in batch order: JAX's batch-sharded forward
    (``_mesh_dispatch``). A batch that does not divide the axis, or no
    mesh, runs ``fn(x)`` whole on every rank."""
    sl = None if mesh is None else mesh.rows(x.shape[0], axis)
    if sl is None:
        return fn(x)
    return all_gather(fn(x[sl]), mesh.group(axis), dim)


def replicate(tree, mesh: Optional[Mesh] = None, src: int = 0):
    """Broadcast from rank ``src`` in place: a module's parameters and
    buffers, a dict of tensors, or a tensor; returns ``tree``."""
    if not dist.is_initialized():
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = [v for v in tree.values() if torch.is_tensor(v)]
    else:
        tensors = [tree]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter)
                           else t, src)
    return tree


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data",
                dim: int = 0) -> torch.Tensor:
    """This rank's rows of ``x`` (dim ``dim``) over ``axis``; a size that
    does not divide raises ``ValueError``."""
    sl = mesh.rows(x.shape[dim], axis)
    if sl is None:
        raise ValueError(f"{x.shape[dim]} rows do not split over "
                         f"{mesh.size(axis)} '{axis}' ranks")
    return x.narrow(dim, sl.start, sl.stop - sl.start)


def sharded_update_fn(estimator, mesh: Mesh, data_axis: str = "data"):
    """``step(state, x, labels)`` -> the state after one update of
    ``estimator`` on the global batch ``x`` split over ``data_axis``
    (JAX's jitted sharded step; the mesh's other axes split as
    ``Estimator.use_mesh`` says)."""
    estimator.use_mesh(mesh, data_axis=data_axis)

    def step(state, x, labels=None):
        estimator.state = state
        return estimator.update(x, labels=labels)
    return step
