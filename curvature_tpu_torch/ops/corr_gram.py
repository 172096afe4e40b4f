"""Patch-Gram via windowed channel correlations (stride-1 convolutions).

Port of ``curvature_tpu/ops/corr_gram.py`` for groups=1. Stride-1 patch
columns are shifted copies of one padded image, so the Gram entry for taps
d and d' is a windowed correlation that depends on delta = d' - d only:
the k^4 tap pairs collapse onto (2k-1)^2 full-field [C, C] correlations
plus exact single-row/column/corner boundary corrections, and delta/-delta
pairs are transposes. FLOPs: 2*N*C^2*(2k^2 - 2k + 1) against 2*N*C^2*k^4.

The JAX version is plain XLA, so this is plain torch ops (matmuls over
shifted slices), not a hand-written kernel.
"""
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from curvature_tpu_torch.ops.patches import resolve_padding

__all__ = ["corr_patch_gram", "corr_gram_supported"]


def corr_gram_supported(kernel_size, strides) -> bool:
    kh, kw = kernel_size
    return tuple(strides) == (1, 1) and (kh, kw) != (1, 1)


def _corr(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """sum over all leading axes of a1[..., c] a2[..., d] -> [C, C]."""
    c = a1.shape[-1]
    return a1.reshape(-1, c).T @ a2.reshape(-1, c)


def corr_patch_gram(x: torch.Tensor,
                    kernel_size: Tuple[int, int],
                    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                    has_bias: bool = True) -> torch.Tensor:
    """Unnormalized patch Gram ``[F(+1), F(+1)]`` for a stride-1 conv over
    NHWC ``x``: canonical (c, dy, dx) feature order, optional ones column
    last, f32 output."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    (pt, pb), (pl, pr) = resolve_padding(padding, h, w, kernel_size)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    hp, wp = h + pt + pb, w + pl + pr
    ho, wo = hp - kh + 1, wp - kw + 1
    n_tok = b * ho * wo

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
            full[(-dy, -dx)] = full[(dy, dx)].T

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

    # assemble the k^2 x k^2 grid of [C, C] blocks
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
    bk = torch.stack(blocks)                          # [K, K', C, C']
    k2 = kh * kw
    # feature order (c, tap): [C, K, C', K']
    gram = bk.permute(2, 0, 3, 1).reshape(c * k2, c * k2)
    if has_bias:
        # ones column: per-tap window channel sums
        sums = torch.stack([xp[:, dy:dy + ho, dx:dx + wo].sum(dim=(0, 1, 2))
                            for (dy, dx) in taps])    # [K, C]
        vec = sums.T.reshape(-1)                      # (c, tap) order
        top = torch.cat([gram, vec[:, None]], dim=1)
        n = torch.full((1,), float(n_tok), dtype=gram.dtype,
                       device=gram.device)
        gram = torch.cat([top, torch.cat([vec, n])[None, :]], dim=0)
    return gram
