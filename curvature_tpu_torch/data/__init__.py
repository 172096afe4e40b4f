from curvature_tpu_torch.data import loaders
from curvature_tpu_torch.data.synthetic import synthetic_images

__all__ = ["loaders", "synthetic_images"]
