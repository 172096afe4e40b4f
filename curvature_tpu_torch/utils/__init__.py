from curvature_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
