"""Symmetric token Gram ``X^T X`` from the lower-triangular tiles only: the
CUDA kernels, their plain PyTorch versions, and the JAX shape gate.

Port of ``curvature_tpu/ops/pallas/sym_gram.py``: :func:`sym_gram`
replaces the Pallas ``sym_gram`` (sym_gram.py:85; kernels ``_kernel`` :53
for ``variant='tri'`` and ``_kernel_rect`` :66 for ``'rect'``). The
contract is the JAX one: ``[N, F]`` float32 or bfloat16 in, ``[F, F]``
float32 out, f32 sums; below the gate (:func:`sym_gram_supported`, from
``_plan``) it is one plain product, as the JAX function's einsum. The two
variants only chose a grid the TPU's compiler accepted, so both run the
same kernels here (``csrc/sym_gram.cu``, whose header says what bounds
them), on the tensor cores (``wgmma``):

  * f32 runs 3xTF32, as the f32 patch Gram: each value split into TF32
    halves (``patch_gram.tf32_split``) and ``lo*hi + hi*lo + hi*hi``
    summed in f32, within ~2^-21 of the f32 products. The transpose and
    the split are done once per call, not once per tile, by a pre-pass
    (:func:`tf32_presplit`, plain version :func:`tf32_presplit_plain`)
    that writes both halves as ready-made swizzled slabs; the tile kernel
    copies them straight into shared memory.
  * bf16 runs bf16 x bf16 -> f32, exact products. Its kernel copies 16
    bytes (8 features) at a time, so its rows must be a multiple of 8
    features: the wrapper appends zero features (:func:`pad_features`;
    the callers' ones column makes F odd) and the kernel writes only the
    leading [F, F].

The result is bitwise symmetric: the upper triangle is written from the
lower triangle's values.

No path calls it, in JAX or here; it is public API. For a CPU tensor it
computes its plain version; for a CUDA tensor above the gate it launches
the kernels or raises. ``sym_gram.launches`` and
``tf32_presplit.launches`` count kernel launches only.
"""
import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from curvature_tpu_torch.ops.cuda.patch_gram import (
    MAX_CHAIN_TOKENS, check_device, check_kernel_dtype, resident_slots,
    split_count, tf32_split)

__all__ = ["sym_gram", "sym_gram_plain", "sym_gram_supported",
           "tf32_presplit", "tf32_presplit_plain"]

#: edge of the workspace tiles (TILE in csrc/gram_tile.cuh)
_TILE = 64
#: edges of the kernels' output tiles (64 * TF_WGS and 64 * WGS in
#: csrc/sym_gram.cu)
F32_TILE = 128
BF16_TILE = 64
#: tokens a chunk of the pre-split slabs (tf::BK in csrc/tf32x3_gram.cuh)
CHUNK = 32
#: f32: one split, written straight from the accumulators, whenever one
#: split fills at least this many waves of resident blocks: from 1.16
#: waves up a second split's reduce pass cost more than the last wave's
#: idle share saved, at 0.34 waves less (PERF.md)
ONE_PASS_WAVES = 1
#: the most tokens one bf16 block sums: its tensor-core accumulator is not
#: flushed into an f32 total, and its truncation error grows with the
#: chain (2.4e-5 of max|G| at MAX_CHAIN_TOKENS, over the 2e-5 bar; PERF.md)
BF16_CHAIN_TOKENS = MAX_CHAIN_TOKENS // 4
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


def pad_features(x: torch.Tensor) -> torch.Tensor:
    """``x`` ([N, F]) with zero features appended up to a multiple of 8,
    as a fresh (aligned) copy; ``x`` itself where F % 8 == 0 and its data
    is 16-byte aligned. The leading [F, F] of its Gram is ``x``'s."""
    f = x.shape[1]
    if f % 8 == 0 and x.data_ptr() % 16 == 0:
        return x
    return F.pad(x, (0, -f % 8))


def presplit_shape(n: int, f: int) -> Tuple[int, ...]:
    """Shape of :func:`tf32_presplit`'s output for an [n, f] input: (hi
    and lo, token chunks, 64-feature blocks covering f in whole F32_TILE
    tiles, 64 feature rows, 8 token quads, 4 tokens)."""
    return (2, -(-n // CHUNK), -(-f // F32_TILE) * F32_TILE // 64, 64, 8, 4)


def tf32_presplit_plain(x: torch.Tensor) -> torch.Tensor:
    """The pre-pass in plain torch ops: ``tf32_split(x)``'s hi and lo, each
    zero-padded to whole chunks of CHUNK tokens and whole F32_TILE-feature
    tiles, cut into [64 features x CHUNK tokens] slabs (one per chunk and
    64-feature block, features as rows), and swizzled as the tensor cores
    read them: quad j (tokens 4j..4j+3) of feature row r stands at
    position j ^ (r % 8)."""
    n, f = x.shape
    _, nc, fb, _, _, _ = presplit_shape(n, f)
    r = torch.arange(64, device=x.device).view(64, 1)
    pos = torch.arange(8, device=x.device).view(1, 8)

    def slabs(h):
        h = F.pad(h, (0, fb * 64 - f, 0, nc * CHUNK - n))
        h = h.view(nc, CHUNK // 4, 4, fb, 64).permute(0, 3, 4, 1, 2)
        return h[:, :, r, pos ^ (r % 8)]     # position p holds quad p ^ r%8
    return torch.stack([slabs(h) for h in tf32_split(x)])


def split_plan(n: int, f: int, bf16: bool, slots: int) -> Tuple[int, int]:
    """(splits, tokens per split) of a launch over [n, f] with ``slots``
    resident blocks, counting the kernel's block tiles: the wave-filling
    count, except in f32 one split (one pass, no reduce) when one split
    fills ONE_PASS_WAVES waves; in both cases at least enough that no
    block sums more than its chain cap (MAX_CHAIN_TOKENS, bf16
    BF16_CHAIN_TOKENS). f32 splits are whole chunks of the pre-split
    slabs."""
    edge, cap = (BF16_TILE, BF16_CHAIN_TOKENS) if bf16 \
        else (F32_TILE, MAX_CHAIN_TOKENS)
    nt = -(-f // edge)
    tiles = nt * (nt + 1) // 2
    one_pass = not bf16 and tiles >= ONE_PASS_WAVES * slots
    splits = max(1 if one_pass else split_count(n, tiles, slots),
                 -(-n // cap))
    per = -(-n // splits)
    if not bf16:
        per = -(-per // CHUNK) * CHUNK
    return -(-n // per), per


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from curvature_tpu_torch.ops.cuda import build
    lib = build.load("sym_gram")
    p, i = ctypes.c_void_p, ctypes.c_int
    # x, hi, lo; N F; stream
    lib.tf32_presplit_f32.argtypes = [p] * 3 + [i] * 2 + [p]
    # hi, lo, out, ws; N F splits chunks-per-split; stream
    lib.sym_gram_f32.argtypes = [p] * 4 + [i] * 4 + [p]
    # x, out, ws; N F ld splits tokens-per-split; stream
    lib.sym_gram_bf16.argtypes = [p] * 3 + [i] * 5 + [p]
    for fn in (lib.tf32_presplit_f32, lib.sym_gram_f32, lib.sym_gram_bf16,
               lib.sym_gram_blocks_per_sm):
        fn.restype = ctypes.c_int
    lib.sym_gram_blocks_per_sm.argtypes = [i, ctypes.POINTER(i)]
    lib.sym_gram_error_string.argtypes = [i]
    lib.sym_gram_error_string.restype = ctypes.c_char_p
    return lib


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{_lib().sym_gram_error_string(rc).decode()}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, bf16: bool) -> int:
    return resident_slots(device_index, functools.partial(
        _lib().sym_gram_blocks_per_sm, int(bf16)))


def tf32_presplit(x: torch.Tensor) -> torch.Tensor:
    """The f32 kernel's operands: :func:`tf32_presplit_plain` of ``x``
    ([N, F] float32), computed by the pre-pass kernel on a CUDA tensor."""
    check_device(x, "tf32_presplit")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"tf32_presplit: takes a 2-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return tf32_presplit_plain(x)
    x = x.contiguous()
    n, f = x.shape
    out = torch.empty(presplit_shape(n, f), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        _check(_lib().tf32_presplit_f32(
            x.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), n, f,
            _stream(x)), "tf32_presplit")
    tf32_presplit.launches += 1
    return out


tf32_presplit.launches = 0


def _launch(x: torch.Tensor) -> torch.Tensor:
    suffix = check_kernel_dtype(x, "sym_gram")
    x = x.contiguous()
    n, f = x.shape
    if n * (f + 7) >= 2 ** 31:
        raise ValueError(f"sym_gram: the kernel indexes with 32-bit ints; "
                         f"{tuple(x.shape)} is too large")
    bf16 = suffix == "bf16"
    splits, per_split = split_plan(n, f, bf16,
                                   _resident_blocks(x.device.index, bf16))
    nt = -(-f // _TILE)
    out = torch.empty((f, f), dtype=torch.float32, device=x.device)
    # one split writes out directly: no workspace
    ws = torch.empty(0 if splits == 1
                     else splits * nt * (nt + 1) // 2 * _TILE * _TILE,
                     dtype=torch.float32, device=x.device)
    lib = _lib()
    if bf16:
        x = pad_features(x)
        args = (x.data_ptr(), out.data_ptr(), ws.data_ptr(), n, f,
                x.shape[1], splits, per_split)
    else:
        op = tf32_presplit(x)
        args = (op[0].data_ptr(), op[1].data_ptr(), out.data_ptr(),
                ws.data_ptr(), n, f, splits, per_split // CHUNK)
    with torch.cuda.device(x.device):
        _check(getattr(lib, f"sym_gram_{suffix}")(*args, _stream(x)),
               "sym_gram")
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
