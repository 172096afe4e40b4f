from curvature_tpu_torch.nn.core import (
    Context, LayerMeta, apply_matrix_delta, matrix_to_delta, param_matrix,
)
from curvature_tpu_torch.nn.layers import (
    GELU, AdaptiveAvgPool, Add, AvgPool, BatchNorm, ChannelLayerNorm, Conv,
    CtxModule, Dense, Flatten, GlobalAvgPool, Hardsigmoid, Hardswish, Identity,
    LayerNorm, MaxPool, ReLU, ReLU6, Sequential, SiLU, normalize_padding,
)
from curvature_tpu_torch.nn.scan import ScanBlocks

__all__ = ["Context", "LayerMeta", "apply_matrix_delta", "matrix_to_delta",
           "param_matrix", "GELU", "AdaptiveAvgPool", "Add", "AvgPool",
           "BatchNorm", "ChannelLayerNorm", "Conv", "CtxModule", "Dense",
           "Flatten", "GlobalAvgPool", "Hardsigmoid", "Hardswish", "Identity",
           "LayerNorm", "MaxPool", "ReLU", "ReLU6", "ScanBlocks",
           "Sequential", "SiLU", "normalize_padding"]
