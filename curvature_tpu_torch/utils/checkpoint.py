"""Checkpointing: factor states and model variables on disk.

Port of ``curvature_tpu/utils/checkpoint.py``: a nested dict of arrays keyed
by layer names, saved as a compressed npz whose keys join the path with
``::``, under the same artefact layout
(``<root>/factors/<prefix><model>_<data>_<estimator><suffix>[rank]``,
``<results>/<model>/data/<estimator>/...``). A file written by either
package loads in the other with identical arrays. Tensors are saved as
their numpy arrays (copied to the host); loading gives numpy arrays
(``models.state_from_jax`` places them on a device). The orbax format
is not ported. In a multi-rank run only rank 0 writes (:func:`write_once`,
which every rank calls); every rank reads.
"""
import os
from typing import Dict, Tuple

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


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
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
            out.update(_flatten(val, path))
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


def save_pytree_orbax(path: str, tree: Dict):
    raise NotImplementedError(
        "orbax checkpoints (the JAX package's sharded format) are not "
        "ported (ROADMAP Queue 1 item 10b); use save_pytree")


def load_pytree_orbax(path: str, shardings: Dict = None) -> Dict:
    raise NotImplementedError(
        "orbax checkpoints (the JAX package's sharded format) are not "
        "ported (ROADMAP Queue 1 item 10b); use load_pytree")


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
