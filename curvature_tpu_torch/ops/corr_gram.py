"""Patch-Gram via windowed channel correlations (stride-1 convolutions).

Port of ``curvature_tpu/ops/corr_gram.py``. Stride-1 patch
columns are shifted copies of one padded image, so the Gram entry for taps
d and d' is a windowed correlation that depends on delta = d' - d only:
the k^4 tap pairs collapse onto (2k-1)^2 full-field [C, C] correlations
plus exact single-row/column/corner boundary corrections, and delta/-delta
pairs are transposes. FLOPs: 2*N*C^2*(2k^2 - 2k + 1) against 2*N*C^2*k^4.
A grouped conv (``groups`` > 1) correlates within-group channel pairs only
([G, cg, cg] per delta), giving the per-group blocks [G, Fg(+1), Fg(+1)]
in the layout of ``estimators.base.grouped_act_tokens`` (JAX :26-29).

On a CUDA tensor with ``groups == 1`` the same mathematics runs as one
hand-written kernel (``ops/cuda/corr_gram.py``, ``csrc/corr_gram.cu``):
every product on the tensor cores in two launches, with no per-block
torch op on the host. A CPU tensor, and the grouped route, take the torch
composition below (matmuls over shifted slices), which is also the
kernel's plain version.
"""
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from curvature_tpu_torch.ops.cuda.corr_gram import corr_gram
from curvature_tpu_torch.ops.cuda.launch import KERNEL_DTYPES
from curvature_tpu_torch.ops.patches import resolve_padding

__all__ = ["corr_patch_gram", "corr_gram_supported", "corr_patch_gram_plain"]


def corr_gram_supported(kernel_size, strides, groups: int = 1) -> bool:
    kh, kw = kernel_size
    return tuple(strides) == (1, 1) and (kh, kw) != (1, 1)


def _corr(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """sum over all leading axes of a1[..., g, c] a2[..., g, d] -> [G, C,
    C]: one batched product over the groups."""
    g, c = a1.shape[-2:]
    a1 = a1.reshape(-1, g, c).transpose(0, 1)
    a2 = a2.reshape(-1, g, c).transpose(0, 1)
    return a1.mT @ a2


def corr_patch_gram(x: torch.Tensor,
                    kernel_size: Tuple[int, int],
                    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                    has_bias: bool = True,
                    groups: int = 1) -> torch.Tensor:
    """Unnormalized patch Gram for a stride-1 conv over NHWC ``x``
    (:func:`corr_patch_gram_plain`'s contract): the CUDA kernel for a
    CUDA tensor of one group, with input other than float32 or bfloat16
    taken as float32 as the composition takes it; the composition
    otherwise."""
    if x.device.type == "cuda" and groups == 1:
        if x.dtype not in KERNEL_DTYPES:
            x = x.float()
        return corr_gram(x.contiguous(), kernel_size, padding, has_bias)
    return corr_patch_gram_plain(x, kernel_size, padding, has_bias, groups)


def corr_patch_gram_plain(x: torch.Tensor,
                          kernel_size: Tuple[int, int],
                          padding: Union[str, Sequence[Tuple[int, int]]]
                          = "SAME",
                          has_bias: bool = True,
                          groups: int = 1) -> torch.Tensor:
    """Unnormalized patch Gram for a stride-1 conv over NHWC ``x``:
    canonical (c, dy, dx) feature order, optional ones column last, f32
    output; ``[F(+1), F(+1)]`` for ``groups == 1``, the per-group blocks
    ``[G, Fg(+1), Fg(+1)]`` (Fg = (C/G)*kh*kw) otherwise. bf16 operands
    are upcast before the products, which are exact in f32: f32
    accumulation, as the JAX bf16 einsums."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    cg = c // groups
    (pt, pb), (pl, pr) = resolve_padding(padding, h, w, kernel_size)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    hp, wp = h + pt + pb, w + pl + pr
    ho, wo = hp - kh + 1, wp - kw + 1
    n_tok = b * ho * wo
    # the group axis split once; the slices below keep the trailing [G, cg]
    xp = xp.reshape(b, hp, wp, groups, cg)

    # full-field correlations: the lexicographically-positive half, the
    # rest mirrored as transposes
    full = {}
    for dy in range(-(kh - 1), kh):
        for dx in range(-(kw - 1), kw):
            if (dy, dx) < (0, 0):
                continue
            ly, hy = max(0, -dy), min(hp, hp - dy)
            lx, hx = max(0, -dx), min(wp, wp - dx)
            full[(dy, dx)] = _corr(xp[:, ly:hy, lx:hx],
                                   xp[:, ly + dy:hy + dy, lx + dx:hx + dx])
    for (dy, dx) in list(full):
        if (dy, dx) != (0, 0):
            full[(-dy, -dx)] = full[(dy, dx)].mT

    # boundary corrections: rows/columns/corners of the padded field that
    # fall outside a tap's window; the set union dedupes overlapping
    # candidate ranges when the output extent is below k-1
    row_corr, col_corr, corner = {}, {}, {}
    row_cand = sorted(set(range(0, kh - 1)) | set(range(ho, hp)))
    col_cand = sorted(set(range(0, kw - 1)) | set(range(wo, wp)))
    for dy in range(-(kh - 1), kh):
        for dx in range(-(kw - 1), kw):
            ly, hy = max(0, -dy), min(hp, hp - dy)
            lx, hx = max(0, -dx), min(wp, wp - dx)
            for y in row_cand:
                if ly <= y < hy:
                    row_corr[(y, dy, dx)] = _corr(
                        xp[:, y, lx:hx], xp[:, y + dy, lx + dx:hx + dx])
            for xq in col_cand:
                if lx <= xq < hx:
                    col_corr[(xq, dy, dx)] = _corr(
                        xp[:, ly:hy, xq], xp[:, ly + dy:hy + dy, xq + dx])
            for y in row_cand:
                for xq in col_cand:
                    if ly <= y < hy and lx <= xq < hx:
                        corner[(y, xq, dy, dx)] = _corr(
                            xp[:, y, xq], xp[:, y + dy, xq + dx])

    # assemble the k^2 x k^2 grid of [G, cg, cg] blocks
    taps = [(dy, dx) for dy in range(kh) for dx in range(kw)]
    blocks = []
    for (dy, dx) in taps:
        row_blocks = []
        for (dy2, dx2) in taps:
            dly, dlx = dy2 - dy, dx2 - dx
            ly, hy = max(0, -dly), min(hp, hp - dly)
            lx, hx = max(0, -dlx), min(wp, wp - dlx)
            blk = full[(dly, dlx)]
            for y in row_cand:
                if ly <= y < hy and not (dy <= y < dy + ho):
                    blk = blk - row_corr[(y, dly, dlx)]
            for xq in col_cand:
                if lx <= xq < hx and not (dx <= xq < dx + wo):
                    blk = blk - col_corr[(xq, dly, dlx)]
            for y in row_cand:
                for xq in col_cand:
                    if ly <= y < hy and lx <= xq < hx \
                            and not (dy <= y < dy + ho) \
                            and not (dx <= xq < dx + wo):
                        blk = blk + corner[(y, xq, dly, dlx)]
            row_blocks.append(blk)
        blocks.append(torch.stack(row_blocks))
    bk = torch.stack(blocks)                          # [K, K', G, cg, cg']
    k2 = kh * kw
    # per-group feature order (c, tap): [G, cg, K, cg', K']
    gram = bk.permute(2, 3, 0, 4, 1).reshape(groups, cg * k2, cg * k2)
    if has_bias:
        # ones column: per-tap window channel sums, per group
        sums = torch.stack([xp[:, dy:dy + ho, dx:dx + wo].sum(dim=(0, 1, 2))
                            for (dy, dx) in taps])    # [K, G, cg]
        vec = sums.permute(1, 2, 0).reshape(groups, -1)   # (c, tap) order
        top = torch.cat([gram, vec[:, :, None]], dim=2)
        n = torch.full((groups, 1), float(n_tok), dtype=gram.dtype,
                       device=gram.device)
        gram = torch.cat([top, torch.cat([vec, n], dim=1)[:, None, :]],
                         dim=1)
    return gram[0] if groups == 1 else gram
