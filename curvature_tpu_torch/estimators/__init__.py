from curvature_tpu_torch.estimators.base import (
    Estimator, act_tokens, filter_metas, grad_tokens, normalize_damping,
)
from curvature_tpu_torch.estimators.capture import (
    Captured, ce_cotangent, collect, sample_labels,
)
from curvature_tpu_torch.estimators.kfac import KFAC

__all__ = ["Estimator", "act_tokens", "filter_metas", "grad_tokens",
           "normalize_damping", "Captured", "ce_cotangent", "collect",
           "sample_labels", "KFAC"]
