from curvature_tpu_torch.estimators.base import (
    Estimator, act_tokens, filter_metas, grad_tokens, grouped_act_tokens,
    normalize_damping,
)
from curvature_tpu_torch.estimators.block import BlockDiagonal
from curvature_tpu_torch.estimators.capture import (
    Captured, ce_cotangent, collect, sample_labels,
)
from curvature_tpu_torch.estimators.diagonal import Diagonal
from curvature_tpu_torch.estimators.efb import EFB, kfac_eigenvectors
from curvature_tpu_torch.estimators.inf import INF
from curvature_tpu_torch.estimators.kfac import KFAC
from curvature_tpu_torch.estimators.swag import SWAG, update_batch_stats

__all__ = ["Estimator", "act_tokens", "filter_metas", "grad_tokens",
           "grouped_act_tokens", "normalize_damping", "Captured",
           "ce_cotangent", "collect", "sample_labels", "KFAC", "Diagonal",
           "BlockDiagonal", "EFB", "INF", "kfac_eigenvectors", "SWAG",
           "update_batch_stats"]

#: estimators of the JAX package not ported yet, and where they stand
_NOT_PORTED = {"Subspace": "ROADMAP Queue 1 item 8"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet ({_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
