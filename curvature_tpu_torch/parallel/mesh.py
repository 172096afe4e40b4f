"""Device meshes over ``torch.distributed`` ranks, and the collectives the
port runs on them.

Port of ``curvature_tpu/parallel/mesh.py`` for the ``data`` axis (the
batch split over ranks) and the ``sample`` axis (Monte-Carlo label draws
and posterior samples split over ranks). A :class:`Mesh` lays its named
axes row-major over the launched world (``"sample:2,data:4"``: rank = 4 *
sample index + data index) and holds one process group per axis: the ranks
that differ only in that axis's index. JAX gets the global-batch program
from GSPMD; here every rank runs its own rows and the results meet in
these collectives, which run where the tensors are (NCCL or gloo on the
card, gloo on the CPU; ``parallel.initialize`` picks the backend).

A collective that fails raises; no rank carries on alone. Without an
initialized process group a mesh has one rank and every collective here
is the identity. JAX's ``model``, ``tensor``, ``seq`` and ``expert`` axes
are not ported yet (ROADMAP Queue 1 item 10b): ``build_mesh`` and
``Estimator.use_mesh`` raise ``NotImplementedError`` for them.
"""
import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

#: the axes the port shards over
PORTED_AXES = ("data", "sample")
#: JAX's other canonical axes, not ported yet
LATER_AXES = ("model", "tensor", "seq", "expert")


def later_axes_error(axes) -> NotImplementedError:
    return NotImplementedError(
        f"mesh axes {sorted(axes)} (model, tensor, sequence and expert "
        "parallelism) are not ported yet (ROADMAP Queue 1 item 10b); the "
        "port shards over 'data' and 'sample'")


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
                self._groups[axis] = self._make_group(axis, world)

    def _lines(self, axis: str) -> List[List[int]]:
        """Every line of ranks along ``axis``, in a fixed order."""
        sizes = [self.shape[a] for a in self.axis_names]
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        i = self.axis_names.index(axis)
        lines = {}
        for r in range(math.prod(sizes)):
            key = r - ((r // strides[i]) % sizes[i]) * strides[i]
            lines.setdefault(key, []).append(r)
        return [lines[k] for k in sorted(lines)]

    def _make_group(self, axis: str, world: int):
        size = self.shape[axis]
        if size == world:
            return dist.group.WORLD
        if size == 1:
            return None
        mine = None
        # every rank creates every group, in the same order
        for ranks in self._lines(axis):
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def index(self, axis: Optional[str]) -> int:
        return self.coords.get(axis, 0) if axis else 0

    def group(self, axis: Optional[str]):
        return self._groups.get(axis) if axis else None

    def rows(self, n: int, axis: str = "data") -> Optional[slice]:
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
    ``--parallel`` alone: every rank on ``data``). Axes other than
    ``data`` and ``sample`` raise: JAX's model, tensor, seq and expert axes
    ``NotImplementedError`` (ROADMAP Queue 1 item 10b), any other name
    ``ValueError``."""
    spec = getattr(cfg, "mesh", "")
    if not spec:
        return None
    axes = parse_spec(spec)
    later = set(axes) & set(LATER_AXES)
    if later:
        raise later_axes_error(later)
    unknown = set(axes) - set(PORTED_AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not used by any "
                         "sharding rule; the axes are 'data' and 'sample'")
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
    (JAX's jitted sharded step; the factor state stays replicated)."""
    estimator.use_mesh(mesh, data_axis=data_axis)

    def step(state, x, labels=None):
        estimator.state = state
        return estimator.update(x, labels=labels)
    return step
