"""Checkpointing: factor states and model variables on disk.

Port of ``curvature_tpu/utils/checkpoint.py``: a nested dict of arrays keyed
by layer names, saved as a compressed npz whose keys join the path with
``::``, under the same artefact layout
(``<root>/factors/<prefix><model>_<data>_<estimator><suffix>[rank]``,
``<results>/<model>/data/<estimator>/...``). A file written by either
package loads in the other with identical arrays. Tensors are saved as
their numpy arrays (copied to the host); loading gives numpy arrays
(``models.state_from_jax`` places them on a device). In a multi-rank run
only rank 0 writes (:func:`write_once`, which every rank calls); every
rank reads.

A state split over a mesh (``Estimator.use_mesh``: the model, tensor and
expert axes) checkpoints without a gather (:func:`save_pytree_sharded`,
the counterpart of JAX's orbax checkpoint, :61-85, in the port's own
format): a directory holding ``index.json`` (every leaf's whole shape,
dtype and split dims, written by rank 0) and one npz of blocks per
distinct block-holding rank, named by its indices on the splitting axes.
:func:`load_pytree_sharded` with a mesh of the same axes gives each rank
its own blocks straight from its file; without one it assembles the whole
tree. A JAX orbax directory is refused with ``NotImplementedError``:
reading one needs orbax, a JAX library.
"""
import itertools
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "::"


def write_once(fn, *args, **kwargs):
    """Run the file-writing call ``fn(*args, **kwargs)`` on rank 0 only
    (the one process of a single-process run), then wait until every rank
    gets here, so that a rank reading the file next finds it whole."""
    from curvature_tpu_torch.parallel.distributed import barrier, is_writer
    if is_writer():
        fn(*args, **kwargs)
    barrier()


def _flatten(tree: Dict, prefix: str = "", leaf: bool = False
             ) -> Dict[str, np.ndarray]:
    """``{path: array}`` of a nested dict; ``leaf`` keeps the leaves as
    they are (a plan's spec lists)."""
    out = {}
    for key, val in tree.items():
        if _SEP in str(key):
            # a silent collision with the separator would scramble the
            # round trip instead of failing here
            raise ValueError(
                f"pytree key {key!r} contains the checkpoint separator "
                f"{_SEP!r}; rename the layer/module")
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, path, leaf))
        elif leaf:
            out[path] = val
        elif torch.is_tensor(val):
            out[path] = val.detach().cpu().numpy()
        else:
            out[path] = np.asarray(val)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, val in flat.items():
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_pytree(path: str, tree: Dict):
    """Save a nested dict of arrays or tensors as an uncompressed npz
    (JAX writes a compressed one; ``np.load`` reads either, so each
    package reads the other's). Factor states are noisy floats that
    barely compress, and deflating them took 18.6 s of a ~20 s ResNet-18
    ``factors`` run (NVIDIA H100 80GB HBM3, 700.00 W); a rank-32 subspace
    state of ResNet-18 is 2.9 GB."""
    flat = _flatten(tree)

    def write():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **flat)
    write_once(write)


def load_pytree(path: str) -> Dict:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


#: the index file of a sharded checkpoint, and its format tag
INDEX, FORMAT = "index.json", "curvature_tpu_torch.sharded/1"
#: files an orbax checkpoint directory holds
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt",
                  "_sharding", "checkpoint")


def _block_file(coords: Dict[str, int]) -> str:
    return "blocks" + "".join(f"_{a}{i}" for a, i in sorted(coords.items())
                              ) + ".npz"


def save_pytree_sharded(path: str, tree: Dict, plan: Optional[Dict] = None,
                        mesh=None):
    """Write ``tree`` (this rank's blocks) as a sharded checkpoint
    directory at ``path``. ``plan`` is the tree of per-leaf axis specs
    (``Estimator.state_plan()``; None: every leaf whole) over ``mesh``.
    Every rank calls it; of the ranks holding the same blocks the one at
    index 0 of every other axis writes them."""
    from curvature_tpu_torch.parallel.distributed import barrier, is_writer
    flat = _flatten(tree)
    specs = _flatten(plan, leaf=True) if plan is not None else {}
    split_axes = sorted({a for spec in specs.values() for a in spec
                         if a is not None and mesh.size(a) > 1})
    coords = {a: mesh.index(a) for a in split_axes}
    leaves = {}
    for key, arr in flat.items():
        split = [[d, a] for d, a in enumerate(specs.get(key, ()))
                 if a in coords]
        shape = list(arr.shape)
        for d, a in split:
            shape[d] *= mesh.size(a)
        leaves[key] = {"shape": shape, "dtype": arr.dtype.str,
                       "split": split}
    os.makedirs(path, exist_ok=True)
    others = [] if mesh is None else [a for a in mesh.axis_names
                                      if a not in coords]
    if all(mesh.index(a) == 0 for a in others):
        np.savez(os.path.join(path, _block_file(coords)), **flat)
    if is_writer():
        with open(os.path.join(path, INDEX), "w") as f:
            json.dump({"format": FORMAT,
                       "axes": {a: mesh.size(a) for a in split_axes},
                       "leaves": leaves}, f)
    barrier()


def load_pytree_sharded(path: str, mesh=None) -> Dict:
    """Read a :func:`save_pytree_sharded` directory: with ``mesh`` (whose
    splitting axes have the saved sizes) this rank's blocks, from its own
    file; without one the whole tree, as numpy arrays. A JAX orbax
    directory raises ``NotImplementedError``."""
    index_path = os.path.join(path, INDEX)
    if not os.path.exists(index_path):
        if os.path.isdir(path) and any(
                os.path.exists(os.path.join(path, m))
                for m in _ORBAX_MARKERS):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint (the JAX package's "
                "save_pytree_orbax); reading it needs orbax, a JAX library. "
                "Restore it with the JAX package and write it with "
                "save_pytree, or write the state with save_pytree_sharded")
        raise FileNotFoundError(f"no sharded checkpoint at {path}")
    with open(index_path) as f:
        index = json.load(f)
    if index.get("format") != FORMAT:
        raise ValueError(f"{index_path}: unknown format "
                         f"{index.get('format')!r}")
    axes = index["axes"]
    if mesh is not None:
        for a, size in axes.items():
            if mesh.size(a) != size:
                raise ValueError(f"{path} was split over {axes}; this mesh "
                                 f"has {a}:{mesh.size(a)}")
        name = _block_file({a: mesh.index(a) for a in axes})
        with np.load(os.path.join(path, name)) as data:
            return _unflatten({k: data[k] for k in data.files})
    whole = {k: np.empty(v["shape"], np.dtype(v["dtype"]))
             for k, v in index["leaves"].items()}
    names = sorted(axes)
    for idx in itertools.product(*(range(axes[a]) for a in names)):
        coords = dict(zip(names, idx))
        with np.load(os.path.join(path, _block_file(coords))) as data:
            for key, meta in index["leaves"].items():
                block = data[key]
                where = [slice(None)] * block.ndim
                for d, a in meta["split"]:
                    where[d] = slice(coords[a] * block.shape[d],
                                     (coords[a] + 1) * block.shape[d])
                whole[key][tuple(where)] = block
    return _unflatten(whole)


def factors_path(cfg, estimator: str = None, rank: str = "") -> str:
    """``<root>/factors/<prefix><model>_<data>_<estimator><suffix>[rank]``
    (reference factors.py:70-71, 122-129)."""
    est = estimator or cfg.estimator
    name = f"{cfg.prefix}{cfg.model}_{cfg.data}_{est}{cfg.suffix}{rank}"
    return os.path.join(cfg.root_dir, "factors", name)


def results_paths(cfg, subdir: str = "") -> Tuple[str, str]:
    """(results_path, fig_path) under the reference's layout
    (evaluate.py:325-329); both directories are created."""
    filename = f"{cfg.prefix}{cfg.model}_{cfg.data}{cfg.suffix}"
    data_dir = os.path.join(cfg.results_dir, cfg.model, "data",
                            cfg.estimator, subdir)
    fig_dir = os.path.join(cfg.results_dir, cfg.model, "figures",
                           cfg.estimator, subdir)
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(fig_dir, exist_ok=True)
    return os.path.join(data_dir, filename), os.path.join(fig_dir, filename)
