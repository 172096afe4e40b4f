"""The encoder transformer classifier: token ids, pre-LN residual blocks,
learned positional embeddings, a mean-pooled head.

Port of ``curvature_tpu/models/transformer2.py`` (:33-77). Every
projection is a tracked layer: each block's attention ``block{i}.attn``
(``nn.MultiheadAttention``: ``block{i}.attn/in_proj`` and ``/out_proj``),
its MLP ``block{i}.mlp.fc1`` and ``.fc2`` (ReLU between), and ``head``;
the embeddings are JAX's ``embed`` group (``table`` and ``pos``), the
LayerNorms ``block{i}.ln1``, ``.ln2`` and ``ln_f`` (eps 1e-5, the port's
``nn.LayerNorm``, JAX's biased variance).
"""
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    Context, CtxModule, Dense, LayerNorm, MultiheadAttention)
from curvature_tpu_torch.utils.device import resolve_device


class TokenEmbedding(nn.Module):
    """The ``embed`` parameter group: ``table`` [vocab, dim] and ``pos``
    [max_len, dim], kept under one JAX group (``models.convert``)."""

    jax_group = True

    def __init__(self, vocab: int, dim: int, max_len: int):
        super().__init__()
        self.table = nn.Parameter(0.02 * torch.randn(vocab, dim))
        self.pos = nn.Parameter(0.02 * torch.randn(max_len, dim))

    def forward(self, tokens):
        return self.table[tokens] + self.pos[None, :tokens.shape[1]]


class MLP(CtxModule):
    """``fc1`` -> ReLU -> ``fc2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x, ctx: Optional[Context] = None):
        return self.fc2(F.relu(self.fc1(x, ctx)), ctx)


class EncoderBlock(CtxModule):
    """x += attn(ln1(x)); x += mlp(ln2(x))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = MultiheadAttention(dim, heads)
        self.ln2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp_ratio * dim)

    def forward(self, x, ctx: Optional[Context] = None):
        x = x + self.attn(self.ln1(x), ctx)
        return x + self.mlp(self.ln2(x), ctx)


class Encoder(ZooNet):
    """Token ids [B, T] -> logits [B, num_classes]."""

    def __init__(self, vocab: int, dim: int, heads: int, depth: int,
                 max_len: int, num_classes: int, mlp_ratio: int = 4):
        super().__init__()
        self.embed = TokenEmbedding(vocab, dim, max_len)
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(dim, heads, mlp_ratio))
        self.depth = depth
        self.ln_f = LayerNorm(dim)
        self.head = Dense(dim, num_classes)
        self.name_layers()

    def forward(self, tokens, ctx: Optional[Context] = None):
        x = self.embed(tokens)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, ctx)
        return self.head(self.ln_f(x).mean(dim=1), ctx)


def transformer_encoder(vocab: int = 1000, dim: int = 128, heads: int = 4,
                        depth: int = 4, max_len: int = 128,
                        num_classes: int = 10, device=None) -> Encoder:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return Encoder(vocab, dim, heads, depth, max_len, num_classes).to(
        resolve_device(device))
