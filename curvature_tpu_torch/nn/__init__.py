from curvature_tpu_torch.nn.core import (
    Context, LayerMeta, apply_matrix_delta, matrix_to_delta, param_matrix,
)
from curvature_tpu_torch.nn.layers import (
    BatchNorm, Conv, Dense, GlobalAvgPool, MaxPool, ReLU, normalize_padding,
)

__all__ = ["Context", "LayerMeta", "apply_matrix_delta", "matrix_to_delta",
           "param_matrix", "BatchNorm", "Conv", "Dense", "GlobalAvgPool",
           "MaxPool", "ReLU", "normalize_padding"]
