from curvature_tpu_torch.nn.core import (
    Context, LayerMeta, apply_matrix_delta, matrix_to_delta, param_key,
    param_matrix,
)
from curvature_tpu_torch.nn.layers import (
    GELU, AdaptiveAvgPool, Add, AvgPool, BatchNorm, ChannelLayerNorm, Conv,
    CtxModule, Dense, Experts, Flatten, GlobalAvgPool, Hardsigmoid,
    Hardswish, Identity, LayerNorm, MaxPool, MoE, MultiheadAttention, ReLU,
    ReLU6, RMSNorm, Sequential, SiLU, apply_rope_interleaved, is_tracked,
    normalize_padding, rope_cos_sin,
)
from curvature_tpu_torch.nn.scan import ScanBlocks

__all__ = ["Context", "LayerMeta", "apply_matrix_delta", "matrix_to_delta",
           "param_key", "param_matrix", "GELU", "AdaptiveAvgPool", "Add",
           "AvgPool", "BatchNorm", "ChannelLayerNorm", "Conv", "CtxModule",
           "Dense", "Experts", "Flatten", "GlobalAvgPool", "Hardsigmoid",
           "Hardswish", "Identity", "LayerNorm", "MaxPool", "MoE",
           "MultiheadAttention", "ReLU", "ReLU6", "RMSNorm", "ScanBlocks",
           "Sequential", "SiLU", "apply_rope_interleaved", "is_tracked",
           "normalize_padding", "rope_cos_sin"]
