"""Swin Transformer v1 and v2 (torchvision ``swin_{t,s,b}``,
``swin_v2_{t,s,b}``).

Port of ``curvature_tpu/models/swin.py`` (:28-274). The window attention's
``qkv`` and ``proj`` are tracked Dense layers on ``[B*windows, N, C]``
tokens, the MLP's ``mlp.0``/``mlp.3`` and the patch merging's
``reduction`` on NHWC maps, V2's continuous position bias ``cpb_mlp.0``
and ``cpb_mlp.2`` on its coordinate table; the bias tables and V2's
``logit_scale`` are raw parameters, ``relative_position_index`` and V2's
``relative_coords_table`` buffers (JAX keeps all of them as ``"value"``
params: ``models.convert`` carries them across). Module paths are
torchvision's (``features.1.0.attn.qkv``, ``features.2.reduction``,
``norm``, ``head``). The patch embedding conv runs on NCHW input; the
stages run on NHWC maps, as torchvision's.

The window bookkeeping is JAX's and torchvision's: pad to whole windows,
the cyclic shift and its boundary mask, the relative-position bias; V2
takes cosine attention scaled by the clamped ``logit_scale``, adds
16·sigmoid of the cpb bias, and subtracts the key bias the tracked
``qkv`` applied (torchvision zeroes it). The softmax runs in f32 and casts
back.
"""
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from curvature_tpu_torch.models.blocks import ZooNet
from curvature_tpu_torch.models.vit import MLPBlock
from curvature_tpu_torch.nn import (
    Context, Conv, CtxModule, Dense, LayerNorm, ReLU, Sequential)
from curvature_tpu_torch.utils.device import resolve_device


def _relative_position_index(ws: int) -> np.ndarray:
    """torchvision's ``define_relative_position_index``: [ws^4] indices
    into the [(2ws-1)^2, heads] bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))            # [2, ws, ws]
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).reshape(-1)


@functools.lru_cache(maxsize=None)
def _attention_mask(ph: int, pw: int, ws: int, s0: int, s1: int
                    ) -> np.ndarray:
    """[windows, N, N] mask separating the regions a window straddles
    after the cyclic shift (torchvision's slices, negative bounds
    included): 0 within a region, -100 across."""
    m = np.zeros((ph, pw), np.float32)
    cnt = 0.0
    for h0, h1 in ((0, -ws), (-ws, -s0 if s0 else None),
                   (-s0 if s0 else None, None)):
        for w0, w1 in ((0, -ws), (-ws, -s1 if s1 else None),
                       (-s1 if s1 else None, None)):
            m[h0:h1, w0:w1] = cnt
            cnt += 1.0
    m = m.reshape(ph // ws, ws, pw // ws, ws)
    m = m.transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    am = m[:, None, :] - m[:, :, None]
    return np.where(am != 0, -100.0, 0.0).astype(np.float32)


def _relative_coords_table(ws: int) -> np.ndarray:
    """V2's log-spaced [1, 2ws-1, 2ws-1, 2] input grid of ``cpb_mlp``."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    t = np.stack(np.meshgrid(r, r, indexing="ij")).transpose(1, 2, 0)[None]
    t = t / (ws - 1) * 8.0
    return (np.sign(t) * np.log2(np.abs(t) + 1.0) / 3.0).astype(np.float32)


class Permute(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute(self.dims)


class ShiftedWindowAttention(CtxModule):
    """Pad -> cyclic shift -> windows -> attention with the
    relative-position bias (and the shift mask) -> merge -> unshift ->
    unpad, on NHWC maps. ``v2``: cosine attention, the ``cpb_mlp`` bias,
    the key bias removed."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 v2: bool = False):
        super().__init__()
        self.heads = heads
        self.window = window
        self.shift = shift
        self.v2 = v2
        n_table = (2 * window - 1) ** 2
        # registration order is JAX's call order: qkv, cpb_mlp, proj
        self.qkv = Dense(dim, 3 * dim)
        if v2:
            self.cpb_mlp = Sequential([Dense(2, 512), ReLU(),
                                       Dense(512, heads, bias=False)])
            self.logit_scale = nn.Parameter(
                torch.full((heads, 1, 1), math.log(10.0)))
            self.register_buffer("relative_coords_table", torch.from_numpy(
                _relative_coords_table(window)))
        else:
            self.relative_position_bias_table = nn.Parameter(
                0.02 * torch.randn(n_table, heads))
        self.proj = Dense(dim, dim)
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index(window)))

    def _bias(self, n: int, ctx):
        """The relative-position bias [heads, N, N]."""
        if self.v2:
            table = self.cpb_mlp(self.relative_coords_table, ctx)
            table = table.reshape(-1, self.heads)
        else:
            table = self.relative_position_bias_table
        bias = table[self.relative_position_index]
        bias = bias.reshape(n, n, self.heads).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(bias) if self.v2 else bias

    def forward(self, x, ctx: Optional[Context] = None):
        b, h, w, c = x.shape
        ws, heads = self.window, self.heads
        hd = c // heads
        pad_b = (ws - h % ws) % ws
        pad_r = (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        ph, pw = h + pad_b, w + pad_r
        s0 = 0 if ws >= ph else self.shift
        s1 = 0 if ws >= pw else self.shift
        if s0 or s1:
            x = torch.roll(x, (-s0, -s1), (1, 2))
        nh, nw = ph // ws, pw // ws
        n = ws * ws
        xw = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(b * nh * nw, n, c)

        qkv = self.qkv(xw, ctx)
        qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.v2:
            # the tracked qkv applied the key bias; torchvision zeroes it
            k = k - self.qkv.bias[c:2 * c].reshape(heads, 1, hd).to(k.dtype)
            qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            kn = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            attn = qn @ kn.transpose(-2, -1)
            scale = torch.exp(self.logit_scale.clamp(max=math.log(100.0)))
            attn = attn * scale.to(attn.dtype)
        else:
            attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        attn = attn + self._bias(n, ctx)[None].to(attn.dtype)
        if s0 or s1:
            mask = torch.from_numpy(_attention_mask(ph, pw, ws, s0, s1)).to(
                attn.device, attn.dtype)
            attn = attn.reshape(b, nh * nw, heads, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)

        y = (attn @ v).transpose(1, 2).reshape(-1, n, c)
        y = self.proj(y, ctx)
        y = y.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, ph, pw, c)
        if s0 or s1:
            y = torch.roll(y, (s0, s1), (1, 2))
        return y[:, :h, :w]


class SwinBlock(CtxModule):
    """v1: pre-norm residual blocks; v2: res-post-norm (the norm on the
    attention's and the MLP's output, before the residual add)."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 v2: bool = False):
        super().__init__()
        self.v2 = v2
        self.norm1 = LayerNorm(dim)
        self.attn = ShiftedWindowAttention(dim, heads, window, shift, v2)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x, ctx: Optional[Context] = None):
        if self.v2:
            x = x + self.norm1(self.attn(x, ctx))
            return x + self.norm2(self.mlp(x, ctx))
        x = x + self.attn(self.norm1(x), ctx)
        return x + self.mlp(self.norm2(x), ctx)


class PatchMerging(CtxModule):
    """2x2 neighbourhood concat (4C, odd sizes padded) -> LayerNorm ->
    bias-free ``reduction`` to 2C; v2 reduces first and norms the 2C
    output."""

    def __init__(self, dim: int, v2: bool = False):
        super().__init__()
        self.v2 = v2
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim if v2 else 4 * dim)

    def forward(self, x, ctx: Optional[Context] = None):
        h, w = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        if self.v2:
            return self.norm(self.reduction(x, ctx))
        return self.reduction(self.norm(x), ctx)


#: arch -> (embed dim, per-stage depths, per-stage heads, window, v2)
_CONFIGS = {
    "swin_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7, False),
    "swin_s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7, False),
    "swin_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7, False),
    "swin_v2_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 8, True),
    "swin_v2_s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 8, True),
    "swin_v2_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 8, True),
}


class SwinTransformer(ZooNet):
    """NCHW images -> logits: ``features`` (the 4x4 patch embedding, the
    stages and their mergings), ``norm``, the spatial mean, ``head``."""

    def __init__(self, embed: int, depths, heads, window: int,
                 num_classes: int, v2: bool = False):
        super().__init__()
        stages = [Sequential([Conv(3, embed, 4, stride=4),
                              Permute((0, 2, 3, 1)), LayerNorm(embed)])]
        dim = embed
        for s, (d, nh) in enumerate(zip(depths, heads)):
            stages.append(Sequential([
                SwinBlock(dim, nh, window, 0 if j % 2 == 0 else window // 2,
                          v2) for j in range(d)]))
            if s + 1 < len(depths):
                stages.append(PatchMerging(dim, v2))
                dim *= 2
        self.features = Sequential(stages)
        self.norm = LayerNorm(dim)
        self.head = Dense(dim, num_classes)
        self.name_layers()

    def forward(self, x, ctx: Optional[Context] = None):
        x = self.norm(self.features(x, ctx))
        return self.head(x.mean(dim=(1, 2)), ctx)


def swin(arch: str, num_classes: int = 1000, device=None
         ) -> SwinTransformer:
    """A torchvision Swin by name, built on ``device`` (CUDA unless
    ``"cpu"`` is passed)."""
    embed, depths, heads, window, v2 = _CONFIGS[arch]
    return SwinTransformer(embed, depths, heads, window, num_classes,
                           v2).to(resolve_device(device))


def swin_t(num_classes: int = 1000, device=None) -> SwinTransformer:
    return swin("swin_t", num_classes, device)
