from curvature_tpu_torch.data import loaders
from curvature_tpu_torch.data.synthetic import synthetic_images, synthetic_tokens

__all__ = ["loaders", "synthetic_images", "synthetic_tokens"]
