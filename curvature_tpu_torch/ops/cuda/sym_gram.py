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
    halves (``launch.tf32_split``) and ``lo*hi + hi*lo + hi*hi``
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

No JAX path calls it; it is public API. For a CPU tensor it computes its
plain version; for a CUDA tensor above the gate it launches the kernels or
raises. ``sym_gram.launches`` and ``tf32_presplit.launches`` count kernel
launches only, of these two wrappers.

:func:`sym_gram_batched` is the port's own f32 entry, with no JAX
counterpart: one pre-pass and one Gram launch for a batch of row segments
of one row matrix, a Gram each: the depth slices of a stacked ``[L, N,
F]`` factor input (any strides with contiguous features: a transposed
view needs no copy), or an MoE layer's rows sorted by expert, cut at
host ``offsets`` (an empty segment gives an exact-zero Gram). It can
append a bias's ones column itself. KFAC's factor Grams take it on CUDA
f32 inputs that pass :func:`batched_gate`, a crossover measured on the
H100 against cuBLAS's strict-f32 product (PERF.md); its plain version is
the per-segment :func:`sym_gram_plain`, and
:func:`tf32_presplit_batched_plain` that of its pre-pass.
``sym_gram_batched.launches`` counts its launches (a pre-pass and a Gram
each), :func:`tf32_presplit`'s counter none of them.
"""
import ctypes
import functools
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from curvature_tpu_torch.ops.cuda.launch import (
    MAX_CHAIN_TOKENS, check, check_device, check_kernel_dtype,
    resident_slots, split_count, stream, tf32_split)

__all__ = ["batched_gate", "sym_gram", "sym_gram_batched",
           "sym_gram_batched_plain", "sym_gram_plain", "sym_gram_supported",
           "tf32_presplit", "tf32_presplit_batched_plain",
           "tf32_presplit_plain"]

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
#: segments one batched launch takes (MAX_SEGMENTS in csrc/sym_gram.cu);
#: a larger batch is launched in slices of this many
MAX_SEGMENTS = 128
#: the batched kernel's gate, from the sweep of its device and back-to-back
#: times against cuBLAS's strict-f32 product on the H100 (chip_smoke.py
#: --grams over F 128-4096, 128-8192 rows a segment, 1 and 16 segments;
#: PERF.md): a call costs the host 0.07-0.12 ms (two launches and their
#: segment tables) against cuBLAS's 0.02-0.03 ms, so below ~2e9 row x
#: feature x feature products the kernel saved at most 0.045 device ms and
#: lost back to back; from GATE_WORK up, at F >= F32_TILE, it won both
GATE_WORK = 2.4e9


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


def batched_gate(segments: int, rows: int, f: int) -> bool:
    """Whether :func:`sym_gram_batched` takes ``segments`` Grams of ``f``
    features over ``rows`` rows in all: from shape alone, the measured
    crossover against cuBLAS's strict-f32 product (GATE_WORK)."""
    return segments > 0 and f >= F32_TILE and rows * f * f >= GATE_WORK


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


def _with_ones(x: torch.Tensor, ones: bool) -> torch.Tensor:
    return torch.cat([x, x.new_ones(x.shape[:-1] + (1,))], -1) if ones else x


def segments_of(x: torch.Tensor, offsets=None) -> List[torch.Tensor]:
    """The row segments of a batched Gram's input: ``x[..., n, F]``'s
    leading indices, or, with ``offsets`` (host ints, batch + 1), the rows
    ``offsets[b]:offsets[b + 1]`` of ``x[R, F]``."""
    if offsets is None:
        return list(x.reshape((-1,) + x.shape[-2:]))
    _check_offsets(x, offsets)
    return [x[a:b] for a, b in zip(offsets, offsets[1:])]


def tf32_presplit_batched_plain(x: torch.Tensor, offsets=None,
                                ones: bool = False) -> torch.Tensor:
    """The batched pre-pass in plain torch ops: each segment's
    :func:`tf32_presplit_plain` (a ones column appended first with
    ``ones``), concatenated along the chunk axis: no chunk straddles two
    segments, and a segment of no rows has no chunk."""
    return torch.cat([tf32_presplit_plain(_with_ones(t.float(), ones))
                      for t in segments_of(x, offsets)], 1)


def sym_gram_batched_plain(x: torch.Tensor, offsets=None,
                           ones: bool = False) -> torch.Tensor:
    """:func:`sym_gram_batched` in plain torch ops: each segment's
    :func:`sym_gram_plain` (a ones column appended first with ``ones``),
    ``[..., F', F']`` or ``[batch, F', F']`` with ``offsets``."""
    grams = torch.stack([sym_gram_plain(_with_ones(t, ones))
                         for t in segments_of(x, offsets)])
    return grams if offsets is not None else grams.reshape(
        x.shape[:-2] + grams.shape[-2:])


def split_plan(n: int, f: int, bf16: bool, slots: int,
               segments: int = 1) -> Tuple[int, int]:
    """(splits, tokens per split) of a launch over [n, f] with ``slots``
    resident blocks, counting the kernel's block tiles: the wave-filling
    count, except in f32 one split (one pass, no reduce) when one split
    fills ONE_PASS_WAVES waves; in both cases at least enough that no
    block sums more than its chain cap (MAX_CHAIN_TOKENS, bf16
    BF16_CHAIN_TOKENS). f32 splits are whole chunks of the pre-split
    slabs. A batched f32 launch has the block tiles of all its
    ``segments``, and ``n`` is its longest segment's rows."""
    edge, cap = (BF16_TILE, BF16_CHAIN_TOKENS) if bf16 \
        else (F32_TILE, MAX_CHAIN_TOKENS)
    nt = -(-f // edge)
    tiles = segments * nt * (nt + 1) // 2
    one_pass = not bf16 and tiles >= ONE_PASS_WAVES * slots
    splits = max(1 if one_pass else split_count(n, tiles, slots),
                 -(-n // cap))
    per = max(1, -(-n // splits))
    if not bf16:
        per = -(-per // CHUNK) * CHUNK
    return max(1, -(-n // per)), per


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from curvature_tpu_torch.ops.cuda import build
    lib = build.load("sym_gram")
    p, i = ctypes.c_void_p, ctypes.c_int
    # x, hi, lo, base[], len[]; count; ld; F ones; stream
    lib.tf32_presplit_f32.argtypes = [p] * 5 + [i, ctypes.c_longlong, i, i,
                                                p]
    # hi, lo, out, ws, len[]; count F splits chunks-per-split; stream
    lib.sym_gram_f32.argtypes = [p] * 5 + [i] * 4 + [p]
    # x, out, ws; N F ld splits tokens-per-split; stream
    lib.sym_gram_bf16.argtypes = [p] * 3 + [i] * 5 + [p]
    for fn in (lib.tf32_presplit_f32, lib.sym_gram_f32, lib.sym_gram_bf16,
               lib.sym_gram_blocks_per_sm):
        fn.restype = ctypes.c_int
    lib.sym_gram_blocks_per_sm.argtypes = [i, ctypes.POINTER(i)]
    return lib


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, bf16: bool) -> int:
    return resident_slots(device_index, functools.partial(
        _lib().sym_gram_blocks_per_sm, int(bf16)))


def _check_offsets(x: torch.Tensor, offsets):
    if x.dim() != 2:
        raise ValueError(f"sym_gram_batched: offsets cut a 2-D row matrix, "
                         f"got {tuple(x.shape)}")
    if (len(offsets) < 2 or offsets[0] != 0 or offsets[-1] != x.shape[0]
            or any(b < a for a, b in zip(offsets, offsets[1:]))):
        raise ValueError(f"sym_gram_batched: offsets must rise from 0 to "
                         f"{x.shape[0]}, got {list(offsets)}")


def _segment_table(x: torch.Tensor, offsets=None):
    """(row matrix, element offsets of the segments' first rows, their
    rows, the row stride) of a batched Gram's input, as the pre-pass
    reads it: features contiguous, any row and batch strides."""
    if x.stride(-1) != 1:
        x = x.contiguous()
    if offsets is None:
        x3 = x.reshape((-1,) + x.shape[-2:])
        step = x3.stride(0)
        return x3, [b * step for b in range(x3.shape[0])], \
            [x3.shape[1]] * x3.shape[0], x3.stride(1)
    _check_offsets(x, offsets)
    ld = x.stride(0)
    return x, [a * ld for a in offsets[:-1]], \
        [b - a for a, b in zip(offsets, offsets[1:])], ld


#: split_plan of the batched launches, cached: the same shapes recur every
#: update, and the wave-filling search costs more host time than a launch
_batched_plan = functools.lru_cache(maxsize=4096)(split_plan)


def _presplit(x, base, lengths, ld, f, ones):
    """The pre-pass kernel over the segments: [2, chunks, blocks, 64, 8,
    4] f32. Run under the device of ``x``."""
    chunks = sum(-(-n // CHUNK) for n in lengths)
    out = torch.empty((2, chunks) + presplit_shape(1, f)[2:],
                      dtype=torch.float32, device=x.device)
    count = len(lengths)
    check("sym_gram", _lib().tf32_presplit_f32(
        x.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        (ctypes.c_longlong * count)(*base),
        (ctypes.c_int * count)(*lengths), count, ld, f, int(ones),
        stream(x)),
        "tf32_presplit")
    return out


def _presplits(x: torch.Tensor, offsets, ones: bool):
    """(rows of each segment, pre-split operands) of every launch's slice
    of MAX_SEGMENTS segments of :func:`sym_gram_batched`'s arguments, as
    it launches them: the one entry to the batched pre-pass. Run under the
    device of ``x``."""
    x, base, lengths, ld = _segment_table(x, offsets)
    f = x.shape[-1] + bool(ones)
    for b0 in range(0, len(lengths), MAX_SEGMENTS):
        b1 = b0 + MAX_SEGMENTS
        yield lengths[b0:b1], _presplit(x, base[b0:b1], lengths[b0:b1], ld,
                                        f, ones)


def _gram_f32(op, lengths, f, out):
    """The f32 tile kernel (and its reduce) over pre-split segments into
    ``out`` ([segments, f, f]). Run under the device of ``out``."""
    count = len(lengths)
    splits, per_split = _batched_plan(
        max(lengths), f, False, _resident_blocks(out.device.index, False),
        count)
    ws = None
    if splits > 1:
        nt = -(-f // _TILE)
        ws = torch.empty(splits * count * nt * (nt + 1) // 2 * _TILE * _TILE,
                         dtype=torch.float32, device=out.device)
    check("sym_gram", _lib().sym_gram_f32(
        op[0].data_ptr(), op[1].data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        (ctypes.c_int * count)(*lengths), count, f, splits,
        per_split // CHUNK, stream(out)), "sym_gram")


def tf32_presplit(x: torch.Tensor) -> torch.Tensor:
    """The f32 kernel's operands: :func:`tf32_presplit_plain` of ``x``
    ([N, F] float32), computed by the pre-pass kernel on a CUDA tensor.
    ``tf32_presplit.launches`` counts this wrapper's launches;
    :func:`sym_gram_batched` runs the same kernel through ``_presplit``
    and counts it in its own ``launches``."""
    check_device(x, "tf32_presplit")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"tf32_presplit: takes a 2-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return tf32_presplit_plain(x)
    x, base, lengths, ld = _segment_table(x)
    with torch.cuda.device(x.device):
        out = _presplit(x, base, lengths, ld, x.shape[-1], False)
    tf32_presplit.launches += 1
    return out


tf32_presplit.launches = 0


def _launch(x: torch.Tensor) -> torch.Tensor:
    suffix = check_kernel_dtype(x, "sym_gram")
    n, f = x.shape
    if suffix == "f32":
        op = tf32_presplit(x)
        out = torch.empty((1, f, f), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            _gram_f32(op, [n], f, out)
        return out[0]
    x = x.contiguous()
    if n * (f + 7) >= 2 ** 31:
        raise ValueError(f"sym_gram: the kernel indexes with 32-bit ints; "
                         f"{tuple(x.shape)} is too large")
    splits, per_split = split_plan(n, f, True,
                                   _resident_blocks(x.device.index, True))
    nt = -(-f // _TILE)
    out = torch.empty((f, f), dtype=torch.float32, device=x.device)
    # one split writes out directly: no workspace
    ws = torch.empty(0 if splits == 1
                     else splits * nt * (nt + 1) // 2 * _TILE * _TILE,
                     dtype=torch.float32, device=x.device)
    x = pad_features(x)
    with torch.cuda.device(x.device):
        check("sym_gram", _lib().sym_gram_bf16(
            x.data_ptr(), out.data_ptr(), ws.data_ptr(), n, f, x.shape[1],
            splits, per_split, stream(x)), "sym_gram")
    return out


def sym_gram_batched(x: torch.Tensor, offsets=None,
                     ones: bool = False) -> torch.Tensor:
    """``t^T t`` of every row segment ``t`` of ``x`` (f32, [F', F'] each,
    F' = F + ``ones``): the segments are ``x[..., n, F]``'s leading
    indices (out ``[..., F', F']``) or, with ``offsets`` (host ints,
    batch + 1), the rows ``offsets[b]:offsets[b + 1]`` of ``x[R, F]`` (out
    ``[batch, F', F']``). ``ones`` appends a ones column to every row. On
    a CUDA float32 tensor: the 3xTF32 kernels, one pre-pass and one Gram
    launch a slice of MAX_SEGMENTS segments; on a CPU tensor the plain
    version."""
    check_device(x, "sym_gram_batched")
    if x.dim() < 2:
        raise ValueError(f"sym_gram_batched: takes [..., n, F] rows, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return sym_gram_batched_plain(x, offsets, ones)
    if x.dtype != torch.float32:
        raise TypeError(f"sym_gram_batched: the CUDA kernel takes float32, "
                        f"got {x.dtype}")
    lead = x.shape[:-2]
    if offsets is not None:
        _check_offsets(x, offsets)
    count = len(offsets) - 1 if offsets is not None else math.prod(lead)
    f = x.shape[-1] + bool(ones)
    out = torch.empty((count, f, f), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        b0 = 0
        for lengths, op in _presplits(x, offsets, ones):
            _gram_f32(op, lengths, f, out[b0:b0 + len(lengths)])
            b0 += len(lengths)
            del op
            sym_gram_batched.launches += 1
    return out if offsets is not None else out.reshape(lead + (f, f))


sym_gram_batched.launches = 0


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
