"""Multi-rank scaling for factor estimation, training and Bayesian
evaluation on ``torch.distributed``: the data, sample, model, tensor, seq
and expert axes of the JAX package's ``parallel`` (mesh.py,
distributed.py), and the differentiable collectives the split layers
meet in."""
from curvature_tpu_torch.parallel.mesh import (
    Mesh, build_mesh, copy_to_group, gather_partial, gather_replicated,
    make_mesh, mesh_from_spec, reduce_from_group, reduce_scatter, replicate,
    shard_batch, sharded_update_fn,
)
from curvature_tpu_torch.parallel.distributed import (
    global_mesh, host_local_to_global, initialize, process_batch_slice,
)

__all__ = [
    "make_mesh", "mesh_from_spec", "build_mesh", "sharded_update_fn",
    "replicate", "shard_batch",
    "initialize", "global_mesh", "process_batch_slice",
    "host_local_to_global", "Mesh", "gather_replicated", "gather_partial",
    "copy_to_group", "reduce_from_group", "reduce_scatter",
]
