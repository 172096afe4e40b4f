"""The tiny transformer over pre-embedded inputs, for attention-projection
curvature.

Port of ``curvature_tpu/models/transformer.py`` (:12-29): per layer
``block{i}.attn`` (``nn.MultiheadAttention``, no residual, no norm), the
MLP ``block{i}.mlp_in`` -> ReLU -> ``block{i}.mlp_out``, then the mean
over tokens and ``head``. Inputs are ``[B, T, D]``.
"""
from typing import Optional

import torch.nn.functional as F

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    Context, CtxModule, Dense, MultiheadAttention)
from curvature_tpu_torch.utils.device import resolve_device


class MeanPoolHead(CtxModule):
    """The mean over the token axis: [B, T, D] -> [B, D]."""

    def forward(self, x, ctx: Optional[Context] = None):
        return x.mean(dim=1)


class _Block(CtxModule):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(dim, heads)
        self.mlp_in = Dense(dim, 4 * dim)
        self.mlp_out = Dense(4 * dim, dim)

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.attn(x, ctx)
        return self.mlp_out(F.relu(self.mlp_in(x, ctx)), ctx)


class TinyTransformer(ZooNet):
    def __init__(self, dim: int, heads: int, layers: int, num_classes: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block{i}", _Block(dim, heads))
        self.pool = MeanPoolHead()
        self.head = Dense(dim, num_classes)
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x, ctx)
        return self.head(self.pool(x), ctx)


def tiny_transformer(vocab_free_dim: int = 16, num_heads: int = 2,
                     num_layers: int = 2, num_classes: int = 10,
                     device=None) -> TinyTransformer:
    """Pre-embedded inputs [B, T, ``vocab_free_dim``]; built on
    ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return TinyTransformer(vocab_free_dim, num_heads, num_layers,
                           num_classes).to(resolve_device(device))
