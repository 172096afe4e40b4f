"""Parameter placement on a mesh: the port's ``_variable_shardings``.

Port of the parameter half of ``curvature_tpu/estimators/base.py``
``_variable_shardings`` (:416-455). JAX annotates the variables and GSPMD
places them; here :func:`shard_model` replaces the parameters of a model's
modules by this rank's blocks, in place, and the modules' forwards meet
the other ranks' blocks in collectives (nn/layers.py, nn/scan.py):

  * ``model``: a :class:`~curvature_tpu_torch.nn.ScanBlocks` stack whose
    depth divides the axis keeps its block of depths of every parameter;
  * ``expert``: an ``MoE`` whose expert count divides the axis keeps its
    block of experts;
  * ``tensor``: each ``Dense`` named in ``ax["tp"]`` keeps its block of
    output features (weight rows, bias entries).

The metas keep the whole shapes. :func:`take_blocks` cuts a whole state
dict (JAX weights through ``models.load_jax_variables``) to this rank's
blocks.
"""
from typing import Dict, Optional

import torch
from torch import nn

from curvature_tpu_torch.nn.layers import Dense, Experts, MoE, Split
from curvature_tpu_torch.nn.scan import ScanBlocks


def _split(mesh, axis) -> Split:
    return Split(axis, mesh.size(axis), mesh.index(axis), mesh.group(axis))


def _place(module, attr: str, split: Optional[Split], shard):
    """Shard ``module`` along ``split`` (None: whole) unless it already is
    so; a module split another way raises."""
    have = getattr(module, attr)
    if have == split:
        return
    if have is not None:
        raise ValueError(
            f"{type(module).__name__} {getattr(module, 'name', '')!r} is "
            f"already split as {have}, not {split or 'whole'}: build a "
            "fresh model for another mesh or estimator")
    shard(split)


def shard_model(model: nn.Module, mesh, ax: Dict) -> frozenset:
    """Shard ``model``'s parameters over ``mesh`` by the axes ``ax`` (the
    estimator's ``_mesh_axes``: ``model``, ``expert`` and ``tensor`` with
    their sizes, ``tp`` the column-parallel layer names); returns the
    names of the layers held column-parallel. Axes of size one change
    nothing; a module that an earlier placement split otherwise raises
    ``ValueError``."""
    tp = set()
    for m in model.modules():
        if isinstance(m, ScanBlocks):
            _place(m, "mp", _split(mesh, ax["model"])
                   if ax["model_size"] > 1
                   and m.depth % ax["model_size"] == 0 else None,
                   m.shard_depth)
        elif isinstance(m, MoE):
            _place(m, "ep", _split(mesh, ax["expert"])
                   if ax["expert_size"] > 1
                   and m.num_experts % ax["expert_size"] == 0 else None,
                   m.shard_experts)
        elif isinstance(m, Dense) and not isinstance(m, Experts):
            wanted = m.name in ax["tp"] and ax["tensor_size"] > 1
            _place(m, "tp", _split(mesh, ax["tensor"]) if wanted else None,
                   m.shard_columns)
            if wanted:
                tp.add(m.name)
    return frozenset(tp)


def is_split(model: nn.Module) -> bool:
    """Whether some parameter of ``model`` is held as this rank's block."""
    return any(m.__dict__.get("_splits") for m in model.modules())


def take_blocks(model: nn.Module, state_dict: Dict) -> Dict:
    """``state_dict`` (whole tensors under the model's keys) with every
    split parameter cut to this rank's block."""
    out = dict(state_dict)
    for prefix, m in model.named_modules():
        for pname, splits in m.__dict__.get("_splits", {}).items():
            key = f"{prefix}.{pname}" if prefix else pname
            if key not in out:
                continue
            t = torch.as_tensor(out[key])
            for dim, split in splits:
                per = t.shape[dim] // split.size
                t = t.narrow(dim, split.index * per, per)
            out[key] = t.contiguous()
    return out


def gather_blocks(model: nn.Module, state_dict: Dict) -> Dict:
    """:func:`take_blocks`' inverse: ``state_dict`` (this rank's blocks
    under the model's keys, e.g. a posterior draw) with every split
    parameter all-gathered into the whole, on every rank."""
    from curvature_tpu_torch.parallel.mesh import all_gather
    out = dict(state_dict)
    for prefix, m in model.named_modules():
        for pname, splits in m.__dict__.get("_splits", {}).items():
            key = f"{prefix}.{pname}" if prefix else pname
            if key not in out:
                continue
            t = out[key]
            for dim, split in reversed(splits):
                t = all_gather(t, split.group, dim)
            out[key] = t
    return out
