from curvature_tpu_torch.estimators.base import (
    Estimator, act_tokens, filter_metas, grad_tokens, grouped_act_tokens,
    normalize_damping,
)
from curvature_tpu_torch.estimators.block import BlockDiagonal
from curvature_tpu_torch.estimators.capture import (
    Captured, ce_cotangent, collect, gaussian_cotangent, gaussian_nll,
    sample_labels, softmax_cross_entropy,
)
from curvature_tpu_torch.estimators.diagonal import Diagonal
from curvature_tpu_torch.estimators.efb import EFB, kfac_eigenvectors
from curvature_tpu_torch.estimators.inf import INF
from curvature_tpu_torch.estimators.kfac import KFAC
from curvature_tpu_torch.estimators.subspace import Subspace
from curvature_tpu_torch.estimators.swag import SWAG, update_batch_stats

__all__ = ["Estimator", "act_tokens", "filter_metas", "grad_tokens",
           "grouped_act_tokens", "normalize_damping", "Captured",
           "ce_cotangent", "collect", "gaussian_cotangent", "gaussian_nll",
           "sample_labels", "softmax_cross_entropy", "KFAC", "Diagonal",
           "BlockDiagonal", "EFB", "INF", "kfac_eigenvectors", "SWAG",
           "update_batch_stats", "Subspace"]
