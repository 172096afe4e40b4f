from curvature_tpu_torch.utils.casting import cast_floats, cast_input
from curvature_tpu_torch.utils.device import resolve_device

__all__ = ["cast_floats", "cast_input", "resolve_device"]
