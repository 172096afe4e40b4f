"""Vision Transformer (torchvision ``vit_*``).

Port of ``curvature_tpu/models/vit.py`` (:20-132). Every projection is a
tracked layer: the patch embedding ``conv_proj``, each block's packed
``self_attention/in_proj`` and ``self_attention/out_proj``
(``nn.MultiheadAttention``), its MLP ``mlp.0`` and ``mlp.3`` (exact-erf
GELU between) and the classifier ``heads.head``; ``class_token`` and
``encoder.pos_embedding`` are raw parameters, every LayerNorm has eps
1e-6. Module paths are torchvision's (``encoder.layers.encoder_layer_{i}``),
so a torchvision checkpoint converts by ``models.torch_convert``.

``scan_blocks=True`` stacks the encoder layers in a
:class:`~curvature_tpu_torch.nn.ScanBlocks` named ``encoder.layers``
(parameters ``[depth, ...]``, layer names ``encoder.layers.mlp.0`` etc.,
``per_depth_names`` the unrolled prefixes), as JAX's scanned stack.
"""
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.nn import (
    Context, Conv, CtxModule, Dense, LayerNorm, MultiheadAttention,
    ScanBlocks)
from curvature_tpu_torch.utils.device import resolve_device


class MLPBlock(CtxModule):
    """torchvision's ``MLPBlock`` (Linear, GELU, Dropout, Linear, Dropout):
    tracked ``0`` -> exact GELU -> tracked ``3``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.add_module("0", Dense(dim, hidden))
        self.add_module("3", Dense(hidden, dim))

    def forward(self, x, ctx: Optional[Context] = None):
        return getattr(self, "3")(F.gelu(getattr(self, "0")(x, ctx)), ctx)


class ViTBlock(CtxModule):
    """Pre-LN encoder block: x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=1e-6)
        self.self_attention = MultiheadAttention(dim, heads)
        self.ln_2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, mlp_dim)

    def forward(self, x, ctx: Optional[Context] = None):
        x = x + self.self_attention(self.ln_1(x), ctx)
        return x + self.mlp(self.ln_2(x), ctx)


class _Layers(CtxModule):
    """The unrolled ``encoder.layers``: ``encoder_layer_{i}`` in order."""

    def __init__(self, blocks):
        super().__init__()
        for i, blk in enumerate(blocks):
            self.add_module(f"encoder_layer_{i}", blk)

    def forward(self, x, ctx: Optional[Context] = None):
        for blk in self.children():
            x = blk(x, ctx)
        return x


class Encoder(CtxModule):
    """``pos_embedding``, the blocks, the final LayerNorm ``ln``."""

    def __init__(self, seq_len: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, scan_blocks: bool):
        super().__init__()
        self.pos_embedding = nn.Parameter(
            0.02 * torch.randn(1, seq_len, dim))
        if scan_blocks:
            self.layers = ScanBlocks(
                lambda prefix: ViTBlock(dim, heads, mlp_dim), depth,
                "encoder.layers",
                per_depth_names=[f"encoder.layers.encoder_layer_{i}"
                                 for i in range(depth)])
        else:
            self.layers = _Layers(ViTBlock(dim, heads, mlp_dim)
                                  for _ in range(depth))
        self.ln = LayerNorm(dim, eps=1e-6)

    def forward(self, x, ctx: Optional[Context] = None):
        return self.ln(self.layers(x + self.pos_embedding, ctx))


class _Heads(CtxModule):
    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.head = Dense(dim, num_classes)

    def forward(self, x, ctx: Optional[Context] = None):
        return self.head(x, ctx)


class VisionTransformer(ZooNet):
    """NCHW images [B, 3, S, S] -> logits; the class token's output feeds
    the head."""

    #: its sampled ensembles run under ``torch.func.vmap`` at any image
    #: size (``eval/evaluate.py``'s ``vmaps``): on the H100 ViT-B/16's
    #: vmapped bnn30 eval at 224² outran the member loop
    vmap_max_pixels = None

    def __init__(self, image_size: int, patch_size: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, num_classes: int,
                 scan_blocks: bool = False):
        super().__init__()
        self.dim = dim
        self.conv_proj = Conv(3, dim, patch_size, stride=patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        seq_len = (image_size // patch_size) ** 2 + 1
        self.encoder = Encoder(seq_len, dim, depth, heads, mlp_dim,
                               scan_blocks)
        self.heads = _Heads(dim, num_classes)
        self.name_layers()

    @property
    def scan_groups(self):
        layers = self.encoder.layers
        return ({layers.name: layers.scan_group}
                if isinstance(layers, ScanBlocks) else {})

    def forward(self, x, ctx: Optional[Context] = None):
        b = x.shape[0]
        x = self.conv_proj(x, ctx).flatten(2).transpose(1, 2)   # [B, N, D]
        x = torch.cat([self.class_token.expand(b, -1, -1), x], dim=1)
        x = self.encoder(x, ctx)
        return self.heads(x[:, 0], ctx)


def vit(image_size: int = 224, patch_size: int = 16, dim: int = 768,
        depth: int = 12, heads: int = 12, mlp_dim: int = 3072,
        num_classes: int = 1000, scan_blocks: bool = False,
        device=None) -> VisionTransformer:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    return VisionTransformer(image_size, patch_size, dim, depth, heads,
                             mlp_dim, num_classes, scan_blocks).to(
        resolve_device(device))


#: arch -> (patch, dim, depth, heads, mlp_dim), torchvision's
_CONFIGS = {
    "vit_b_16": (16, 768, 12, 12, 3072),
    "vit_b_32": (32, 768, 12, 12, 3072),
    "vit_l_16": (16, 1024, 24, 16, 4096),
    "vit_l_32": (32, 1024, 24, 16, 4096),
    "vit_h_14": (14, 1280, 32, 16, 5120),
}


def vit_arch(arch: str, num_classes: int = 1000, image_size: int = 224,
             scan_blocks: bool = False, device=None) -> VisionTransformer:
    """A torchvision ViT by name; the positional embedding follows
    ``image_size``."""
    patch, dim, depth, heads, mlp_dim = _CONFIGS[arch]
    return vit(image_size, patch, dim, depth, heads, mlp_dim, num_classes,
               scan_blocks, device)


def vit_b_16(num_classes: int = 1000, image_size: int = 224,
             scan_blocks: bool = False, device=None) -> VisionTransformer:
    """torchvision ``vit_b_16``: 12 layers, 12 heads, dim 768, MLP 3072."""
    return vit_arch("vit_b_16", num_classes, image_size, scan_blocks, device)


def vit_b_32(num_classes: int = 1000, image_size: int = 224,
             scan_blocks: bool = False, device=None) -> VisionTransformer:
    return vit_arch("vit_b_32", num_classes, image_size, scan_blocks, device)


def vit_l_16(num_classes: int = 1000, image_size: int = 224,
             scan_blocks: bool = False, device=None) -> VisionTransformer:
    """torchvision ``vit_l_16``: 24 layers, 16 heads, dim 1024, MLP 4096."""
    return vit_arch("vit_l_16", num_classes, image_size, scan_blocks, device)


def vit_l_32(num_classes: int = 1000, image_size: int = 224,
             scan_blocks: bool = False, device=None) -> VisionTransformer:
    return vit_arch("vit_l_32", num_classes, image_size, scan_blocks, device)


def vit_h_14(num_classes: int = 1000, image_size: int = 224,
             scan_blocks: bool = False, device=None) -> VisionTransformer:
    """torchvision ``vit_h_14``: 32 layers, 16 heads, dim 1280, MLP 5120."""
    return vit_arch("vit_h_14", num_classes, image_size, scan_blocks, device)
