"""Symmetric token Gram ``X^T X`` from the lower-triangular tiles only: the
CUDA kernel, its plain PyTorch version, and the JAX shape gate.

Port of ``curvature_tpu/ops/pallas/sym_gram.py``: :func:`sym_gram`
replaces the Pallas ``sym_gram`` (sym_gram.py:85; kernels ``_kernel`` :53
for ``variant='tri'`` and ``_kernel_rect`` :66 for ``'rect'``). The
contract is the JAX one: ``[N, F]`` float32 or bfloat16 in, ``[F, F]``
float32 out, f32 sums of exact products; below the gate
(:func:`sym_gram_supported`, from ``_plan``) it is one plain product, as
the JAX function's einsum. The two variants only chose a grid the TPU's
compiler accepted, so both run the same kernel here (``csrc/sym_gram.cu``,
whose header says what bounds it). The result is bitwise symmetric: the
upper triangle is written from the lower triangle's values.

No path calls it, in JAX or here; it is public API. For a CPU tensor it
computes its plain version; for a CUDA tensor above the gate it launches
the kernel or raises. ``sym_gram.launches`` counts kernel launches only.
"""
import ctypes
import functools
from typing import Tuple

import torch

from curvature_tpu_torch.ops.cuda.patch_gram import (
    KERNEL_DTYPES, check_device, check_kernel_dtype, resident_slots,
    split_count)

__all__ = ["sym_gram", "sym_gram_plain", "sym_gram_supported"]

#: must match TILE in csrc/gram_tile.cuh
_TILE = 64
VARIANTS = ("tri", "rect")


def _plan(n: int, f: int, itemsize: int) -> Tuple[int, int]:
    """(tile_f, tile_n) of the TPU kernel's VMEM plan, copied so that the
    same shapes pass the gate as in JAX."""
    tile_f = 512 if f >= 512 else 256 if f >= 256 else 128
    budget = 8 * 2 ** 20
    tile_n = (budget - tile_f * tile_f * 4) // (4 * tile_f * itemsize)
    tile_n = max(512, min(2048, tile_n // 512 * 512))
    return tile_f, tile_n


def sym_gram_supported(n: int, f: int) -> bool:
    """More than one F tile of the TPU plan (else nothing to skip)."""
    tile_f, _ = _plan(n, f, 4)
    return f > tile_f


def sym_gram_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops: one f32 product of the
    upcast operands (exact bf16 products), its lower triangle mirrored
    above the diagonal as the JAX ``tril(low) + tril(low, -1).T``."""
    xf = x.float()
    g = xf.T @ xf
    return torch.tril(g) + torch.tril(g, -1).T


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from curvature_tpu_torch.ops.cuda import build
    lib = build.load("sym_gram")
    # x, out, ws; N F splits tokens-per-split; stream
    args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"sym_gram_{suffix}")
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.sym_gram_blocks_per_sm.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.sym_gram_blocks_per_sm.restype = ctypes.c_int
    lib.sym_gram_error_string.argtypes = [ctypes.c_int]
    lib.sym_gram_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, bf16: bool) -> int:
    return resident_slots(device_index, functools.partial(
        _lib().sym_gram_blocks_per_sm, int(bf16)))


def _launch(x: torch.Tensor) -> torch.Tensor:
    suffix = check_kernel_dtype(x, "sym_gram")
    x = x.contiguous()
    n, f = x.shape
    if n * f >= 2 ** 31:
        raise ValueError(f"sym_gram: the kernel indexes with 32-bit ints; "
                         f"{tuple(x.shape)} is too large")
    nt = -(-f // _TILE)
    num_tiles = nt * (nt + 1) // 2
    splits = split_count(n, num_tiles,
                         _resident_blocks(x.device.index, suffix == "bf16"))
    per_split = -(-n // splits)
    out = torch.empty((f, f), dtype=torch.float32, device=x.device)
    ws = torch.empty(splits * num_tiles * _TILE * _TILE,
                     dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"sym_gram_{suffix}")(
            x.data_ptr(), out.data_ptr(), ws.data_ptr(), n, f, splits,
            per_split, stream)
    if rc != 0:
        raise RuntimeError(f"sym_gram: CUDA error {rc}: "
                           f"{lib.sym_gram_error_string(rc).decode()}")
    return out


def sym_gram(x: torch.Tensor, variant: str = "tri") -> torch.Tensor:
    """``x.T @ x`` ([N, F] -> [F, F] f32) from the lower-triangular tiles;
    port of the Pallas ``sym_gram`` (``'tri'`` and ``'rect'`` compute the
    same thing)."""
    if variant not in VARIANTS:
        raise ValueError(f"sym_gram: variant {variant!r} not in {VARIANTS}")
    check_device(x, "sym_gram")
    n, f = x.shape
    if not sym_gram_supported(n, f):
        xf = x.float()                  # the JAX function's einsum
        return xf.T @ xf
    if x.device.type == "cpu":
        return sym_gram_plain(x)
    out = _launch(x)
    sym_gram.launches += 1
    return out


sym_gram.launches = 0
