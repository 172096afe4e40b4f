"""Convolution patch extraction for KFAC conv factors.

Port of ``curvature_tpu/ops/patches.py``. Inputs and outputs keep the JAX
layout (NHWC in, ``[B, H', W', C*kh*kw]`` out) so both packages compare
like with like; the work is ``F.pad`` + ``F.unfold``, whose feature axis is
channel-major (c, kh, kw), the order of an OIHW-flattened weight matrix.
"""
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def resolve_padding(padding: Union[str, Sequence[Tuple[int, int]]],
                    h: int, w: int,
                    kernel_size: Tuple[int, int],
                    strides: Tuple[int, int] = (1, 1)):
    """Normalize 'SAME'/'VALID'/explicit conv padding to
    ``((pt, pb), (pl, pr))`` with XLA's stride-aware SAME semantics
    (out = ceil(in/s); the low side gets floor(total/2))."""
    if padding == "SAME":
        kh, kw = kernel_size
        sh, sw = strides

        def same(n, k, s):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            return (total // 2, total - total // 2)
        return same(h, kh, sh), same(w, kw, sw)
    if padding == "VALID":
        return (0, 0), (0, 0)
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def extract_patches(x: torch.Tensor,
                    kernel_size: Tuple[int, int],
                    strides: Tuple[int, int],
                    padding: Union[str, Sequence[Tuple[int, int]]]
                    ) -> torch.Tensor:
    """[B, H, W, C] -> [B, H', W', C*kh*kw] patches, features ordered
    (c, kh, kw)."""
    b, h, w, c = x.shape
    (pt, pb), (pl, pr) = resolve_padding(padding, h, w, kernel_size, strides)
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    kh, kw = kernel_size
    ho = (h + pt + pb - kh) // strides[0] + 1
    wo = (w + pl + pr - kw) // strides[1] + 1
    p = F.unfold(xc, kernel_size, stride=strides)          # [B, F, L]
    return p.transpose(1, 2).reshape(b, ho, wo, c * kh * kw)
