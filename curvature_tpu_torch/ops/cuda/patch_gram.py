"""Fused convolution-patch Gram: the CUDA kernels, their plain PyTorch
versions, and the dispatch policy.

Port of ``curvature_tpu/ops/pallas/patch_gram.py``. The entry points keep
the JAX contract: NHWC ``[B, H, W, C]`` input in float32 or bfloat16,
``[F+1, F+1]`` f32 output (F = C*kh*kw), canonical (c, dy, dx) feature
order, ones column last, the unnormalized Gram (divide by N outside).
bf16 operands give exact products and f32 sums, as the Pallas kernels'
``preferred_element_type=f32``.

  * :func:`patch_gram_tiled` replaces the Pallas ``patch_gram_tiled``
    (patch_gram.py:464, kernel ``_kernel_tiled`` :319);
  * :func:`patch_gram_v2` replaces the Pallas ``patch_gram_v2``
    (patch_gram.py:229, kernels ``_kernel_v2`` :173 and
    ``_kernel_v2_strided`` :196);
  * :func:`patch_gram` replaces the Pallas ``patch_gram`` (patch_gram.py:114,
    kernel ``_kernel`` :72), stride 1 only. No path dispatches it, in JAX
    or here; it is public API.

On Hopper all three are one implicit-im2col Gram kernel body per element
type, templated on stride: (1, 1) and (2, 2) fixed at compile time, any
other (sh, sw) read at run time (``csrc/patch_gram.cu``, whose header says what
bounds it and how the design answers), both on the tensor cores
(``wgmma``). bf16 runs bf16 x bf16 -> f32, exact products. f32 runs
3xTF32: each value is split into TF32 halves (``launch.tf32_split``) and
``lo*hi + hi*lo + hi*hi`` is summed in f32, within ~2^-21 of the f32
products; one TF32 product would miss the JAX tests' 1e-4 bar, and strict
FP32 FMA's bound is 2.5x longer (67 TFLOP/s against 495/3). Both gather 16
bytes at a time where the input allows it (:func:`gather_kind`). The TPU
``patch_gram``'s row strips of ~512 patch rows with a manual HBM->VMEM
halo DMA exist to make a strip fit VMEM; a block here gathers its patch
rows straight from the input, so ``patch_gram`` is the kernel's stride-1
instance and has no strip design.
Each entry point keeps its own wrapper, contract checks and launch counter
(``<fn>.launches``, counting kernel launches only).

For a CPU tensor a wrapper computes its plain version; for a CUDA tensor
it launches the kernel or raises. Nothing falls back.

The dispatch policy (``select_patch_gram``, ``tiled_plan``,
``patch_gram_tiled_supported``, ``patch_gram_v2_supported``) and the
advisory ``patch_gram_supported`` are
copied with the JAX thresholds, so the same layers take a kernel as in
JAX; the thresholds were tuned on a TPU and are not yet re-measured on the
H100.
"""
import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from curvature_tpu_torch.ops.cuda.launch import (
    KERNEL_DTYPES, MAX_CHAIN_TOKENS, check, check_device, check_kernel_dtype,
    resident_slots, split_count, stream)
from curvature_tpu_torch.ops.patches import resolve_padding

MAX_F = 1200
#: edge of the 64x64 workspace tiles (TILE in csrc/gram_tile.cuh)
_TILE = 64
#: edge of the f32 and bf16 kernels' output tiles (64 * TF_WGS and
#: 64 * WGS in csrc/patch_gram.cu)
F32_TILE = 128
BF16_TILE = 128
#: strides with a compile-time kernel instance; any other positive pair
#: runs the run-time-stride instance (counted apart in
#: ``patch_gram_v2.any_stride_launches``)
COMPILED_STRIDES = ((1, 1), (2, 2))


# ---------------------------------------------------------------------------
# dispatch policy (pure shape logic, copied from the JAX module)
# ---------------------------------------------------------------------------

def patch_gram_supported(c: int, kernel_size: Tuple[int, int],
                         strides: Tuple[int, int]) -> bool:
    """Advisory gate of :func:`patch_gram`: stride 1, F+1 <= 1200 and a
    window of more than one tap."""
    kh, kw = kernel_size
    return strides == (1, 1) and c * kh * kw + 1 <= MAX_F and kh * kw > 1


def patch_gram_v2_supported(c: int, kernel_size: Tuple[int, int],
                            strides: Tuple[int, int], h: int, w: int,
                            itemsize: int = 4) -> bool:
    """Gate of the whole-image route: stride 1 or 2, C >= 96, F+1 <= 1200,
    and the TPU's VMEM budget (kept so routing matches JAX)."""
    kh, kw = kernel_size
    f1 = c * kh * kw + 1
    if strides not in ((1, 1), (2, 2)) or kh * kw <= 1 or f1 > MAX_F \
            or c < 96:
        return False
    s = strides[0]
    hp, wp = h + kh - 1 + (s - 1), w + kw - 1 + (s - 1)
    h_out, w_out = -(-h // s), -(-w // s)
    vmem = hp * wp * c * itemsize + h_out * w_out * f1 * itemsize \
        + f1 * f1 * 4
    return vmem <= 12 * 1024 * 1024


def _tiled_layout(c: int, kernel_size: Tuple[int, int], s: int,
                  h_out: int, w_out: int, batch: int, itemsize: int):
    """(kb, nb, bb) of the TPU tiled plan, or None when it cannot fit.
    Only the feasibility and kb drive dispatch here; the CUDA kernel has
    its own tiling."""
    kh, kw = kernel_size
    k = kh * kw
    kb = max((d for d in range(1, k + 1)
              if k % d == 0 and d * c <= 512 and (d * c) % 128 == 0),
             default=None)
    if kb is None and (k * c) ** 2 * 4 <= 4 * 1024 * 1024:
        kb = k
    if kb is None:
        return None
    acc = (kb * c) ** 2 * 4
    f = c * k
    out_cost = f * f * 4 if f * f * 4 <= 6 * 1024 * 1024 else 2 * acc
    budget = 13 * 1024 * 1024
    wp = w_out * s + kw - 1 + (s - 1)

    def cost(hb):
        img = (hb * s + kh - 1 + (s - 1)) * wp * c * itemsize
        pbuf = hb * w_out * kb * c * itemsize
        return 2 * img + 2 * pbuf

    nb = next((d for d in range(1, h_out + 1)
               if h_out % d == 0 and cost(h_out // d) + out_cost <= budget),
              None)
    if nb is None:
        return None
    per = cost(h_out // nb)
    bb = max((d for d in range(1, batch * nb + 1)
              if (batch * nb) % d == 0 and d * per + out_cost <= budget),
             default=1)
    return kb, nb, bb


def tiled_plan(c: int, kernel_size: Tuple[int, int],
               strides: Tuple[int, int], h: int, w: int, batch: int,
               itemsize: int = 4):
    """Feasibility + layout of the tiled route from the raw conv shape."""
    kh, kw = kernel_size
    if kh * kw <= 1 or strides not in ((1, 1), (2, 2)) or c < 32:
        return None
    s = strides[0]
    h_out, w_out = -(-h // s), -(-w // s)
    return _tiled_layout(c, kernel_size, s, h_out, w_out, batch, itemsize)


def patch_gram_tiled_supported(c: int, kernel_size: Tuple[int, int],
                               strides: Tuple[int, int], h: int, w: int,
                               batch: int, itemsize: int = 4) -> bool:
    """Whether the tiled route has a plan for this conv shape (JAX
    :417-421)."""
    return tiled_plan(c, kernel_size, strides, h, w, batch, itemsize) \
        is not None


def select_patch_gram(c: int, kernel_size: Tuple[int, int],
                      strides: Tuple[int, int], h: int, w: int,
                      batch: int, itemsize: int = 4):
    """Kernel policy: ``'v2'`` | ``'tiled'`` | ``None`` (patch path), with
    the JAX package's rules: stride 2 with C >= 96 takes v2; f32 shapes
    whose tiled plan has multi-offset tiles (kb > 1) take tiled; the other
    v2-supported shapes take v2; bf16 keeps only the stride-2 v2 route."""
    if strides == (2, 2) and patch_gram_v2_supported(
            c, kernel_size, strides, h, w, itemsize):
        return "v2"
    if itemsize < 4:
        return None
    plan = tiled_plan(c, kernel_size, strides, h, w, batch, itemsize)
    if plan is not None and plan[0] > 1:
        return "tiled"
    if patch_gram_v2_supported(c, kernel_size, strides, h, w, itemsize):
        return "v2"
    return None


# ---------------------------------------------------------------------------
# plain version (CPU tensors, tests, and the on-card reference)
# ---------------------------------------------------------------------------

def _out_shape(h, w, kernel_size, pads, strides):
    (pt, pb), (pl, pr) = pads
    kh, kw = kernel_size
    return ((h + pt + pb - kh) // strides[0] + 1,
            (w + pl + pr - kw) // strides[1] + 1)


def patch_gram_plain(x: torch.Tensor, kernel_size: Tuple[int, int],
                     padding=((0, 0), (0, 0)),
                     strides: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """The kernels' function in plain torch ops: the patch matrix built
    from kh*kw strided slices of the zero-padded input (one per window
    offset, as the TPU kernels' VMEM copies), a ones column, and one f32
    matmul."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    sh, sw = strides
    pads = resolve_padding(padding, h, w, kernel_size, strides)
    (pt, pb), (pl, pr) = pads
    ho, wo = _out_shape(h, w, kernel_size, pads, strides)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    taps = [xp[:, dy:dy + (ho - 1) * sh + 1:sh, dx:dx + (wo - 1) * sw + 1:sw]
            for dy in range(kh) for dx in range(kw)]     # each [B, Ho, Wo, C]
    p = torch.stack(taps, dim=-1).reshape(-1, c * kh * kw)   # (c, tap) order
    p = torch.cat([p, p.new_ones(p.shape[0], 1)], dim=1)
    return p.T @ p


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from curvature_tpu_torch.ops.cuda import build
    lib = build.load("patch_gram")
    # x, out, ws, colsum; B H W C kh kw sh sw pt pl Ho Wo splits
    # tokens-per-split vec; stream
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"patch_gram_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # sh sw bf16 vec; the count's address
    lib.patch_gram_blocks_per_sm.argtypes = [
        ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.patch_gram_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, strides: Tuple[int, int],
                     bf16: bool, vec: bool) -> int:
    return resident_slots(device_index, functools.partial(
        _lib().patch_gram_blocks_per_sm, *strides, int(bf16), int(vec)))


def gather_kind(x: torch.Tensor) -> str:
    """The gather the kernel takes for ``x`` (NHWC), from its shape and
    address alone: ``'vector'`` (16 bytes of channels of one tap at a time:
    a bf16 ``cp.async`` of 8 channels, an f32 load of 4) when a pixel's C
    channels are a multiple of 16 bytes and the data is 16-byte aligned,
    else ``'scalar'`` (element loads into the same shared-memory
    layout)."""
    return "vector" if x.shape[-1] * x.element_size() % 16 == 0 \
        and x.data_ptr() % 16 == 0 else "scalar"


def plan_splits(n_tokens: int, num_tiles: int, slots: int) -> int:
    """Token splits of a launch over ``n_tokens`` tokens and ``num_tiles``
    block tiles: the wave-filling count, and at least enough that no block
    sums more than MAX_CHAIN_TOKENS in its tensor-core accumulator."""
    return max(split_count(n_tokens, num_tiles, slots),
               -(-n_tokens // MAX_CHAIN_TOKENS))


def block_tiles(f: int, bf16: bool) -> int:
    """Lower-triangular output tiles, one per block of a split, of the
    kernel for ``f`` features."""
    nt = -(-f // (BF16_TILE if bf16 else F32_TILE))
    return nt * (nt + 1) // 2


def _launch(name: str, x: torch.Tensor, kernel_size, pads, strides,
            ho: int, wo: int) -> torch.Tensor:
    suffix = check_kernel_dtype(x, name)
    strides = (int(strides[0]), int(strides[1]))
    if min(strides) < 1:
        raise ValueError(f"{name}: strides {strides} must be positive")
    x = x.contiguous()
    b, h, w, c = x.shape
    kh, kw = kernel_size
    f = c * kh * kw
    nt = -(-f // _TILE)
    num_tiles = nt * (nt + 1) // 2
    n_tokens = b * ho * wo
    if max(x.numel(), n_tokens) >= 2 ** 31:
        raise ValueError(f"{name}: the kernel indexes with 32-bit ints; "
                         f"{tuple(x.shape)} is too large")
    bf16 = suffix == "bf16"
    vec = gather_kind(x) == "vector"
    splits = plan_splits(n_tokens, block_tiles(f, bf16),
                         _resident_blocks(x.device.index, strides, bf16,
                                          vec))
    per_split = -(-n_tokens // splits)
    out = torch.empty((f + 1, f + 1), dtype=torch.float32, device=x.device)
    ws = torch.empty(splits * num_tiles * _TILE * _TILE,
                     dtype=torch.float32, device=x.device)
    colsum = torch.empty(splits * nt * _TILE, dtype=torch.float32,
                         device=x.device)
    args = [b, h, w, c, kh, kw, *strides, pads[0][0], pads[1][0], ho, wo,
            splits, per_split, int(vec)]
    with torch.cuda.device(x.device):
        check("patch_gram", getattr(_lib(), f"patch_gram_{suffix}")(
            x.data_ptr(), out.data_ptr(), ws.data_ptr(), colsum.data_ptr(),
            *args, stream(x)), name)
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def patch_gram_tiled(x: torch.Tensor, kernel_size: Tuple[int, int],
                     padding=((0, 0), (0, 0)),
                     strides: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """[F+1, F+1] unnormalized patch Gram; port of the Pallas
    ``patch_gram_tiled``. Raises where the JAX plan is infeasible, as the
    JAX function does."""
    check_device(x, "patch_gram_tiled")
    b, h, w, c = x.shape
    kh, kw = kernel_size
    pads = resolve_padding(padding, h, w, kernel_size, strides)
    ho, wo = _out_shape(h, w, kernel_size, pads, strides)
    if kh * kw <= 1 or strides not in ((1, 1), (2, 2)) or c < 32 \
            or _tiled_layout(c, kernel_size, strides[0], ho, wo, b,
                             x.element_size()) is None:
        raise ValueError("tiled patch-Gram plan infeasible for this shape")
    if x.device.type == "cpu":
        return patch_gram_plain(x, kernel_size, pads, strides)
    out = _launch("patch_gram_tiled", x, kernel_size, pads, strides, ho, wo)
    patch_gram_tiled.launches += 1
    return out


patch_gram_tiled.launches = 0


def patch_gram_v2(x: torch.Tensor, kernel_size: Tuple[int, int],
                  padding=((0, 0), (0, 0)),
                  strides: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """[F+1, F+1] unnormalized patch Gram; port of the Pallas
    ``patch_gram_v2``, any strides (sh, sw) as there: (1, 1) and (2, 2)
    run the kernel's compile-time instances, any other pair its run-time
    one. ``select_patch_gram`` routes only (2, 2) (and, through the tiled
    plan, (1, 1)) here, as in JAX."""
    check_device(x, "patch_gram_v2")
    b, h, w, c = x.shape
    pads = resolve_padding(padding, h, w, kernel_size, strides)
    ho, wo = _out_shape(h, w, kernel_size, pads, strides)
    if x.device.type == "cpu":
        return patch_gram_plain(x, kernel_size, pads, strides)
    out = _launch("patch_gram_v2", x, kernel_size, pads, strides, ho, wo)
    patch_gram_v2.launches += 1
    if tuple(strides) not in COMPILED_STRIDES:
        patch_gram_v2.any_stride_launches += 1
    return out


patch_gram_v2.launches = 0
patch_gram_v2.any_stride_launches = 0


def patch_gram(x: torch.Tensor, kernel_size: Tuple[int, int],
               padding=((0, 0), (0, 0))) -> torch.Tensor:
    """[F+1, F+1] unnormalized patch Gram of a stride-1 conv; port of the
    Pallas ``patch_gram`` (the JAX signature less ``interpret``: explicit
    pads or ``'SAME'``/``'VALID'``). ``patch_gram_supported`` is advisory
    here as there: any shape the kernel indexes is computed."""
    check_device(x, "patch_gram")
    b, h, w, c = x.shape
    pads = resolve_padding(padding, h, w, kernel_size)
    ho, wo = _out_shape(h, w, kernel_size, pads, (1, 1))
    if x.device.type == "cpu":
        return patch_gram_plain(x, kernel_size, pads)
    out = _launch("patch_gram", x, kernel_size, pads, (1, 1), ho, wo)
    patch_gram.launches += 1
    return out


patch_gram.launches = 0
