"""Correlation patch Gram of a stride-1 convolution: the CUDA kernel's
wrapper and its launch plan.

The function is ``ops/corr_gram.py``'s (``corr_patch_gram`` with
``groups=1``): for NHWC ``x`` in float32 or bfloat16, the unnormalized
``[F(+1), F(+1)]`` f32 Gram of the stride-1 patch matrix, canonical
(c, dy, dx) feature order, ones column last, N in the corner. That
module dispatches: a CUDA tensor of one group comes here and launches
the kernel (``csrc/corr_gram.cu``); its torch composition is the plain
version, for every other input.

The plan. Block (t, t') of the Gram, taps t <= t' (delta = t' - t
lexicographically non-negative; the other half are transposes), sums
``x[b, q] x[b, q + delta]^T`` over the positions q of one rectangle of
the image: the window of tap t within the image, less the rows and
columns whose partner q + delta leaves it. The taps of one delta share
the full-field rectangle (every q with q and q + delta in the image), so
a block is that rectangle's product less its top, bottom, left and right
strips plus the four corners those strips subtract twice, each a
rectangle of the same delta. Padding is never read: every rectangle lies
in the image, and the pads only decide where the windows end. A rectangle
that no block needs is not in the plan (SAME's all-padding rows and
columns among them).

Each rectangle is an *item*: its [C, C] product (the lower tiles only
where delta = 0) over 128x128 output tiles, its tokens cut into splits of
at most MAX_CHAIN_TOKENS. One launch computes every (item, tile, split)
as a block, the longest first; a second sums each block's splits and
terms into the output and the ones row from the delta-0 items' column
sums. ``corr_gram.launches`` counts kernel launches: two a call.
"""
import ctypes
import dataclasses
import functools
import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch

from curvature_tpu_torch.ops.cuda.launch import (
    KERNEL_DTYPES, MAX_CHAIN_TOKENS, check, check_kernel_dtype,
    resident_slots, stream)
from curvature_tpu_torch.ops.patches import resolve_padding

#: output tile edge of the kernel (64 * WGS in csrc/corr_gram.cu)
TILE = 128
#: tokens a chunk of the kernel's loop (tf::BK in csrc/tf32x3_gram.cuh)
CHUNK = 32
#: a block's fixed cost (its set-up and its 64 KB tile store) in chunks,
#: for the plan's estimate of the launch's length
BLOCK_COST_CHUNKS = 8
#: ints of an item row and a block row of the device table; the field
#: order is csrc/corr_gram.cu's
ITEM_FIELDS = ("dy", "dx", "y0", "x0", "rh", "rw", "tokens", "per_split",
               "splits", "base", "sym", "nt")
BLOCK_FIELDS = ("item", "ti", "tj", "split")

Rect = Tuple[int, int, int, int, int, int]     # dy, dx, y0, x0, rh, rw


@dataclasses.dataclass(frozen=True)
class Plan:
    """A call's work: ``items`` (rectangles), ``terms[t, t']`` (the signed
    items that sum to block (t, t'), t <= t'), each item's token splits,
    and the launch's blocks in order."""
    batch: int
    channels: int
    taps: int
    n_tokens: int
    items: Tuple[Rect, ...]
    terms: Dict[Tuple[int, int], Tuple[Tuple[int, int], ...]]
    per_split: Tuple[int, ...]
    splits: Tuple[int, ...]
    base: Tuple[int, ...]
    blocks: Tuple[Tuple[int, int, int, int], ...]
    slots: int

    @property
    def tiles_per_edge(self) -> int:
        return -(-self.channels // TILE)

    def item_tiles(self, i: int) -> List[Tuple[int, int]]:
        return tiles_of(self.tiles_per_edge, self.items[i])

    def table(self) -> np.ndarray:
        """The device table: items, blocks, each (t, t')'s term range and
        the terms, as one int32 array; ``offsets()`` says where each
        starts."""
        k = self.taps
        items = [[*rect, self.batch * rect[4] * rect[5], self.per_split[i],
                  self.splits[i], self.base[i], int(rect[:2] == (0, 0)),
                  self.tiles_per_edge] for i, rect in enumerate(self.items)]
        ranges, terms = np.zeros((k * k, 2), np.int64), []
        for (t, t2), lst in sorted(self.terms.items()):
            ranges[t * k + t2] = (len(terms), len(terms) + len(lst))
            terms += lst
        parts = [np.asarray(items, np.int64).reshape(-1, len(ITEM_FIELDS)),
                 np.asarray(self.blocks, np.int64).reshape(
                     -1, len(BLOCK_FIELDS)),
                 ranges, np.asarray(terms, np.int64).reshape(-1, 2)]
        return np.concatenate([p.ravel() for p in parts]).astype(np.int32)

    def offsets(self) -> Tuple[int, int, int, int]:
        """Where items, blocks, ranges and terms start in ``table()``."""
        a = len(self.items) * len(ITEM_FIELDS)
        b = a + len(self.blocks) * len(BLOCK_FIELDS)
        return 0, a, b, b + 2 * self.taps ** 2


def tiles_of(nt: int, rect: Rect) -> List[Tuple[int, int]]:
    """(ti, tj) output tiles of an item over ``nt`` tiles an edge: the
    lower triangle where delta = 0 (a symmetric product)."""
    sym = rect[:2] == (0, 0)
    return [(ti, tj) for ti in range(nt)
            for tj in range(ti + 1 if sym else nt)]


def out_extent(h: int, w: int, kernel_size, pads) -> Tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    return h + pt + pb - kernel_size[0] + 1, w + pl + pr - kernel_size[1] + 1


def rect_terms(h: int, w: int, kernel_size, pads):
    """(items, terms): the rectangles and, for each tap pair t <= t', the
    signed items whose sum is block (t, t') (empty where the window misses
    every partner)."""
    kh, kw = kernel_size
    (pt, _), (pl, _) = pads
    ho, wo = out_extent(h, w, kernel_size, pads)
    items: Dict[Rect, int] = {}
    terms = {}

    def item(dy, dx, ys, xs):
        key = (dy, dx, ys[0], xs[0], ys[1] - ys[0], xs[1] - xs[0])
        return items.setdefault(key, len(items))

    def within(a, b):
        return max(a[0], b[0]), min(a[1], b[1])

    for t in range(kh * kw):
        ty, tx = divmod(t, kw)
        for t2 in range(t, kh * kw):
            dy, dx = t2 // kw - ty, t2 % kw - tx
            yf = (max(0, -dy), min(h, h - dy))
            xf = (max(0, -dx), min(w, w - dx))
            yt = within(yf, (ty - pt, ty - pt + ho))
            xt = within(xf, (tx - pl, tx - pl + wo))
            if yt[0] >= yt[1] or xt[0] >= xt[1]:
                terms[t, t2] = ()
                continue
            ys = [r for r in ((yf[0], yt[0]), (yt[1], yf[1])) if r[0] < r[1]]
            xs = [r for r in ((xf[0], xt[0]), (xt[1], xf[1])) if r[0] < r[1]]
            terms[t, t2] = ((item(dy, dx, yf, xf), 1),
                            *((item(dy, dx, y, xf), -1) for y in ys),
                            *((item(dy, dx, yf, x), -1) for x in xs),
                            *((item(dy, dx, y, x), 1) for y in ys
                              for x in xs))
    return tuple(items), terms


def _makespan(costs: List[int], slots: int) -> int:
    """Longest-first list schedule of ``costs`` (descending) on
    ``slots`` resident blocks: when the last block ends."""
    free = [0] * min(slots, len(costs))
    for c in costs:
        heapq.heapreplace(free, free[0] + c)
    return max(free)


@functools.lru_cache(maxsize=64)
def make_plan(b: int, h: int, w: int, c: int, kernel_size: Tuple[int, int],
              pads, slots: int) -> Plan:
    """The call's plan. The token cap of a split is the one, among the
    caps that cut the longest item into the fewest splits the chain cap
    allows or up to 63 more, whose blocks the card's ``slots`` resident
    blocks finish soonest (fewer blocks among equals); the blocks run
    longest first. Every output position's window meets the image in
    some tap, so a plan has at least one block."""
    items, terms = rect_terms(h, w, kernel_size, pads)
    ho, wo = out_extent(h, w, kernel_size, pads)
    nt = -(-c // TILE)
    tokens = [b * r[4] * r[5] for r in items]
    tiles = [tiles_of(nt, r) for r in items]
    least = -(-max(tokens) // MAX_CHAIN_TOKENS)
    best = None
    for s in range(least, least + 64):
        cap = -(-max(tokens) // s)
        cap = min(-(-cap // CHUNK) * CHUNK, MAX_CHAIN_TOKENS)
        splits = [-(-n // cap) for n in tokens]
        per = [-(-n // sp) for n, sp in zip(tokens, splits)]
        costs = sorted((-(-p // CHUNK) + BLOCK_COST_CHUNKS
                        for p, sp, ts in zip(per, splits, tiles)
                        for _ in range(sp * len(ts))), reverse=True)
        key = (_makespan(costs, slots), len(costs))
        if best is None or key < best[0]:
            best = (key, splits, per)
    _, splits, per = best
    base, blocks, slot = [], [], 0
    for i, ts in enumerate(tiles):
        base.append(slot)
        blocks += [(i, ti, tj, s) for ti, tj in ts for s in range(splits[i])]
        slot += len(ts) * splits[i]
    blocks.sort(key=lambda blk: -per[blk[0]])     # stable: longest first
    return Plan(b, c, kernel_size[0] * kernel_size[1], b * ho * wo, items,
                terms, tuple(per), tuple(splits), tuple(base), tuple(blocks),
                slot)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from curvature_tpu_torch.ops.cuda import build
    lib = build.load("corr_gram")
    # x, out, ws, colsum, items, blocks, ranges, terms; n_blocks H W C K
    # has_bias n_tokens vec; stream
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"corr_gram_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # bf16 vec; the count's address
    lib.corr_gram_blocks_per_sm.argtypes = [
        ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.corr_gram_blocks_per_sm.restype = ctypes.c_int
    return lib


def vector_gather(x: torch.Tensor) -> bool:
    """Whether the kernel loads 4 channels at a time (16 bytes of f32, 8
    of bf16): C a multiple of 4 and the data aligned to that load."""
    return x.shape[-1] % 4 == 0 \
        and x.data_ptr() % (4 * x.element_size()) == 0


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, bf16: bool, vec: bool) -> int:
    return resident_slots(device_index, functools.partial(
        _lib().corr_gram_blocks_per_sm, int(bf16), int(vec)))


@functools.lru_cache(maxsize=64)
def _device_plan(device_index: int, b, h, w, c, kernel_size, pads,
                 slots: int) -> Tuple[Plan, torch.Tensor]:
    plan = make_plan(b, h, w, c, kernel_size, pads, slots)
    return plan, torch.from_numpy(plan.table()).to(
        torch.device("cuda", device_index))


def check_contract(x: torch.Tensor, kernel_size) -> str:
    """Raises where the kernel does not take ``x``: a dtype other than
    float32 or bfloat16, other than 4 dims, NHWC strides other than
    contiguous, a kernel of no taps, or more elements than 32-bit indices
    reach. Returns the C entry's suffix."""
    suffix = check_kernel_dtype(x, "corr_gram")
    if x.dim() != 4:
        raise ValueError(f"corr_gram: NHWC input has 4 dims, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"corr_gram: NHWC input must be contiguous, got "
                         f"strides {x.stride()}")
    if min(kernel_size) < 1:
        raise ValueError(f"corr_gram: kernel {tuple(kernel_size)}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"corr_gram: the kernel indexes with 32-bit ints; "
                         f"{tuple(x.shape)} is too large")
    return suffix


def corr_gram(x: torch.Tensor, kernel_size: Tuple[int, int],
              padding="SAME", has_bias: bool = True) -> torch.Tensor:
    """[F(+1), F(+1)] unnormalized patch Gram of a stride-1 conv over
    NHWC ``x`` (float32 or bfloat16, contiguous, on CUDA): the kernel's
    two launches."""
    suffix = check_contract(x, kernel_size)
    b, h, w, c = x.shape
    kernel_size = (int(kernel_size[0]), int(kernel_size[1]))
    pads = resolve_padding(padding, h, w, kernel_size)
    ho, wo = out_extent(h, w, kernel_size, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"corr_gram: no output position for {(h, w)} "
                         f"under kernel {kernel_size}, padding {pads}")
    if x.device.type != "cuda":
        raise ValueError(f"corr_gram: the kernel takes a CUDA tensor, got "
                         f"one on {x.device}")
    if b * ho * wo >= 2 ** 31:
        raise ValueError(f"corr_gram: {b * ho * wo} tokens exceed 32 bits")
    vec = vector_gather(x)
    bf16 = suffix == "bf16"
    plan, table = _device_plan(x.device.index, b, h, w, c, kernel_size,
                               pads, _resident_blocks(x.device.index, bf16,
                                                      vec))
    k = kernel_size[0] * kernel_size[1]
    f1 = c * k + int(has_bias)
    out = torch.empty((f1, f1), dtype=torch.float32, device=x.device)
    ws = torch.empty(plan.slots * TILE * TILE, dtype=torch.float32,
                     device=x.device)
    colsum = torch.empty(plan.slots * TILE, dtype=torch.float32,
                         device=x.device)
    ptr = table.data_ptr()
    with torch.cuda.device(x.device):
        check("corr_gram", getattr(_lib(), f"corr_gram_{suffix}")(
            x.data_ptr(), out.data_ptr(), ws.data_ptr(), colsum.data_ptr(),
            *(ptr + 4 * o for o in plan.offsets()), len(plan.blocks), h, w,
            c, k, int(has_bias), plan.n_tokens, int(vec), stream(x)),
            "corr_gram")
    corr_gram.launches += 2
    return out


corr_gram.launches = 0
