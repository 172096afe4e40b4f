"""Hand-written CUDA kernels (sources in ``csrc/``, built by ``build``)."""
from curvature_tpu_torch.ops.cuda.patch_gram import (
    patch_gram_plain, patch_gram_tiled, patch_gram_v2,
    patch_gram_v2_supported, select_patch_gram, tiled_plan,
)

__all__ = ["patch_gram_plain", "patch_gram_tiled", "patch_gram_v2",
           "patch_gram_v2_supported", "select_patch_gram", "tiled_plan"]
