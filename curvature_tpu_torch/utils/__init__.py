from curvature_tpu_torch.utils.casting import cast_floats, cast_input
from curvature_tpu_torch.utils.checkpoint import (
    factors_path, load_pytree, results_paths, save_pytree,
)
from curvature_tpu_torch.utils.config import Config, parse_args, setup
from curvature_tpu_torch.utils.device import resolve_device
from curvature_tpu_torch.utils.monitor import (
    Timer, device_memory_gb, profile_trace, ram, seed_all_rng,
)

__all__ = ["Config", "parse_args", "setup", "save_pytree", "load_pytree",
           "factors_path", "results_paths", "ram", "device_memory_gb",
           "Timer", "profile_trace", "seed_all_rng", "cast_floats",
           "cast_input", "resolve_device"]
