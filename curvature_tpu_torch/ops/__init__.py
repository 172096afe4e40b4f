from curvature_tpu_torch.ops.corr_gram import (
    corr_gram_supported, corr_patch_gram,
)
from curvature_tpu_torch.ops.linalg import (
    chol_inv, chol_logdet, damped_inverse_cholesky, sym,
)
from curvature_tpu_torch.ops.patches import extract_patches, resolve_padding

__all__ = ["corr_gram_supported", "corr_patch_gram", "chol_inv",
           "chol_logdet", "damped_inverse_cholesky", "sym",
           "extract_patches", "resolve_padding"]
