from curvature_tpu_torch.ops.corr_gram import (
    corr_gram_supported, corr_patch_gram,
)
from curvature_tpu_torch.ops.linalg import (
    chol_inv, chol_logdet, damped_inverse_cholesky, diag_add, eigh_sym,
    group_by_shape, kron, sym,
)
from curvature_tpu_torch.ops.matfree import (
    delta_shapes, ggn_matvec, ggn_quad, hutchinson_trace, lanczos_topk,
    random_deltas,
)
from curvature_tpu_torch.ops.patches import extract_patches, resolve_padding

__all__ = ["corr_gram_supported", "corr_patch_gram", "chol_inv",
           "chol_logdet", "damped_inverse_cholesky", "sym", "kron",
           "eigh_sym", "diag_add", "group_by_shape",
           "extract_patches", "resolve_padding", "delta_shapes",
           "random_deltas", "ggn_quad", "ggn_matvec", "lanczos_topk",
           "hutchinson_trace"]
