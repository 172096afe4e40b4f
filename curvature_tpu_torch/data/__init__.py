from curvature_tpu_torch.data import images, loaders
from curvature_tpu_torch.data.prefetch import (
    CachedLoader, DevicePrefetcher, ParallelDecodeLoader,
)
from curvature_tpu_torch.data.synthetic import (
    synthetic_classification, synthetic_images, synthetic_tokens,
)

__all__ = [
    "images", "loaders", "synthetic_classification", "synthetic_images",
    "synthetic_tokens", "CachedLoader", "DevicePrefetcher",
    "ParallelDecodeLoader",
]
