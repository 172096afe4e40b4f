"""Multi-process start-up and per-process batch helpers.

Port of ``curvature_tpu/parallel/distributed.py`` on ``torch.distributed``.
``initialize`` starts the process group, from explicit arguments or from
``torch.distributed.run``'s environment (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``)::

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m curvature_tpu_torch.pipelines.factors --mesh data:2 ...

The backend follows one rule, printed when the group starts: the CPU
(``device="cpu"``) takes gloo; on the card NCCL when every rank of the
host has a GPU of its own, gloo otherwise (NCCL refuses two ranks on one
device; gloo's collectives take CUDA tensors). Each rank's current CUDA
device is its local rank modulo the host's GPUs.
"""
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from curvature_tpu_torch.parallel.mesh import (
    Mesh, all_gather, make_mesh, world_rank, world_size)
from curvature_tpu_torch.utils.device import resolve_device


def pick_backend(device: torch.device, local_world: int):
    """(backend, reason) by the rule of the module docstring."""
    if device.type == "cpu":
        return "gloo", "CPU tensors"
    gpus = torch.cuda.device_count()
    if gpus >= local_world:
        return "nccl", f"{local_world} local ranks on {gpus} GPUs"
    return "gloo", (f"{local_world} local ranks share {gpus} GPU"
                    f"{'s' if gpus > 1 else ''}")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None):
    """Start the default process group; returns its backend, or None.

    ``coordinator_address`` is ``host:port`` of rank 0. Without it the
    ``torch.distributed.run`` environment is read, and a process launched
    without one is a single process: nothing starts. An already started
    group is kept. ``device`` is where the collectives' tensors live
    (``"cpu"``, else the CUDA device, raising without a GPU)."""
    if dist.is_initialized():
        return dist.get_backend()
    env = os.environ
    if coordinator_address is None:
        if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                      "WORLD_SIZE")):
            return None
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id "
                         "with a coordinator_address")
    device = resolve_device(device)
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend, why = pick_backend(device, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    print(f"parallel: rank {process_id} of {num_processes}, backend "
          f"{backend} ({why})", file=sys.stderr, flush=True)
    return backend


def global_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """Mesh over every rank; defaults to one ``data`` axis."""
    return make_mesh(axis_sizes)


def process_batch_slice(global_batch: int) -> slice:
    """The half-open row range of the global batch this process feeds."""
    per = global_batch // world_size()
    start = per * world_rank()
    return slice(start, start + per)


def host_local_to_global(x, mesh: Mesh, axis: str = "data", spec=None,
                         gather: bool = False) -> torch.Tensor:
    """This process's shard ``x`` of an array split over ``axis`` along
    its leading dim (or the dim where ``spec``, e.g. ``(None, "data")``
    for [S, B] labels, names the axis), as a tensor; with ``gather`` the
    whole array, the shards concatenated in axis order."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if not gather:
        return t
    dim = list(spec).index(axis) if spec is not None else 0
    return all_gather(t, mesh.group(axis), dim)


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return world_rank() == 0


def barrier():
    """Wait for every rank (nothing in a single process)."""
    if dist.is_initialized():
        dist.barrier()
