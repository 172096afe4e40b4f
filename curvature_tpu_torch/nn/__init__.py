from curvature_tpu_torch.nn.core import (
    Context, LayerMeta, apply_matrix_delta, matrix_to_delta, param_matrix,
)
from curvature_tpu_torch.nn.layers import (
    BatchNorm, Conv, Dense, Flatten, GlobalAvgPool, LayerNorm, MaxPool, ReLU,
    Sequential, normalize_padding,
)
from curvature_tpu_torch.nn.scan import ScanBlocks

__all__ = ["Context", "LayerMeta", "apply_matrix_delta", "matrix_to_delta",
           "param_matrix", "BatchNorm", "Conv", "Dense", "Flatten",
           "GlobalAvgPool", "LayerNorm", "MaxPool", "ReLU", "ScanBlocks",
           "Sequential", "normalize_padding"]
