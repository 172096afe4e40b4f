"""The correlation patch Gram's CUDA route (``ops/cuda/corr_gram.py``): the
wrapper's contract checks, the dispatch of ``corr_patch_gram``, and the
launch plan, run in plain torch on the CPU against the torch composition
(``corr_patch_gram_plain``, itself held to JAX in
``tests/test_torch_ops.py``).

The ``cuda``-marked tests hold the kernel to the composition and to a
float64 Gram (``OFF_RTOL``, a bar that a single TF32 pass fails, as a CPU
test shows) on the card, and a ``KFAC.update`` on the card to one on the
CPU; they skip where there is no card. This file imports no JAX, so it runs there as it is
(``python -m pytest tests/test_torch_corr_gram.py --noconftest -m cuda``).
"""
import types

import numpy as np
import pytest
import torch

from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.ops import corr_gram as tcorr
from curvature_tpu_torch.ops.cuda import corr_gram as ccg
from curvature_tpu_torch.ops.cuda import launch
from curvature_tpu_torch.ops.patches import resolve_padding

torch.set_num_threads(1)

#: tests/test_torch_ops.py's CORR_CASES (tests/test_corr_gram.py:29-43),
#: and the rectangular kernels, asymmetric pads and an extent below k - 1
CORR_CASES = [
    ((8, 8, 3), (3, 3), ((1, 1), (1, 1)), True),
    ((8, 8, 3), (3, 3), ((1, 1), (1, 1)), False),
    ((9, 7, 4), (3, 3), "SAME", True),
    ((10, 10, 2), (5, 5), ((2, 2), (2, 2)), True),
    ((8, 8, 3), (3, 3), "VALID", True),
    ((12, 12, 5), (3, 3), ((0, 2), (2, 0)), True),
    ((7, 11, 3), (1, 3), ((0, 0), (1, 1)), True),
    ((3, 3, 2), (3, 3), "VALID", True),
    ((3, 8, 2), (5, 5), ((2, 2), (2, 2)), True),
    ((9, 6, 3), (3, 1), ((1, 1), (0, 0)), False),
    ((3, 9, 4), (3, 3), ((0, 0), (1, 1)), True),     # a row block: Ho = 1
    ((4, 5, 3), (5, 5), "SAME", True),
]

#: the kernel's matrix on the card: (B, H, W, C), kernel, padding
CUDA_CASES = [
    ((2, 8, 8, 3), (3, 3), "SAME"),
    ((2, 9, 7, 48), (3, 3), "VALID"),
    ((2, 12, 12, 128), (3, 3), ((0, 2), (2, 0))),
    ((2, 10, 10, 200), (5, 5), "SAME"),
    ((2, 7, 11, 256), (1, 3), ((0, 0), (1, 1))),
    ((2, 9, 6, 48), (3, 1), ((1, 1), (0, 0))),
    ((2, 3, 8, 48), (5, 5), ((2, 2), (2, 2))),        # Ho = 3 < k - 1
    ((3, 3, 3, 3), (3, 3), "VALID"),                  # one output position
    ((2, 4, 9, 128), (3, 3), ((0, 0), (1, 1))),       # a row block: Ho = 2
    ((4, 48, 48, 64), (3, 3), "SAME"),                # N > MAX_CHAIN_TOKENS
    ((16, 28, 28, 128), (3, 3), "SAME"),              # ResNet-50 layer2
    ((16, 14, 14, 256), (3, 3), "SAME"),              # ResNet-50 layer3
]


def _x(shape, seed=0, dtype=torch.float32, device="cpu"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _plan(shape, ks, pad, slots=132):
    b, h, w, c = shape
    return ccg.make_plan(b, h, w, c, ks, resolve_padding(pad, h, w, ks),
                         slots)


def run_plan(x, plan, has_bias):
    """The plan in plain torch (float64): each item's rectangle product
    and column sum, the signed terms of each block (t, t') for t <= t',
    the transposes, the window sums of the delta-0 terms and N."""
    c = x.shape[-1]
    xd = x.double()
    prods, sums = [], []
    for dy, dx, y0, x0, rh, rw in plan.items:
        a = xd[:, y0:y0 + rh, x0:x0 + rw].reshape(-1, c)
        b = xd[:, y0 + dy:y0 + dy + rh, x0 + dx:x0 + dx + rw].reshape(-1, c)
        prods.append(a.T @ b)
        sums.append(a.sum(0))
    k = plan.taps
    blocks = torch.zeros(k, k, c, c, dtype=torch.float64)
    windows = torch.zeros(k, c, dtype=torch.float64)
    for (t, t2), terms in plan.terms.items():
        for item, sign in terms:
            blocks[t, t2] += sign * prods[item]
            if t == t2:
                windows[t] += sign * sums[item]
        if t != t2:
            blocks[t2, t] = blocks[t, t2].T
    gram = blocks.permute(2, 0, 3, 1).reshape(c * k, c * k)
    if has_bias:
        vec = windows.T.reshape(-1)                     # (c, tap) order
        n = torch.tensor([float(plan.n_tokens)], dtype=torch.float64)
        gram = torch.cat([torch.cat([gram, vec[:, None]], 1),
                          torch.cat([vec, n])[None]], 0)
    return gram.float()


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


#: the kernel against the float64 Gram, by :func:`_off_err`. max|G| grows
#: as the tokens (the diagonal, N in the corner), an off-diagonal sum and
#: the rounding of any sum as their square root, so a bar of max|G| loses
#: sight of a lower precision as N grows; one of the off-diagonal entries
#: does not. On the card the kernel read at most 1.09e-6 (f32; bf16 input
#: 4.1e-7) over CUDA_CASES and ResNet-50's shapes at B=128; a single TF32
#: pass reads at least 2.75e-4, bf16 operands 2.27e-3
#: (test_off_diagonal_bar_refuses_lower_precisions)
OFF_RTOL = 1e-5


def _gram64(x, ks, pad, bias=True):
    """The patch Gram in float64 from the unfolded patch matrix: an
    oracle independent of the composition and of the plan."""
    b, h, w, c = x.shape
    (pt, pb), (pl, pr) = resolve_padding(pad, h, w, ks)
    xp = torch.nn.functional.pad(x.double().permute(0, 3, 1, 2),
                                 (pl, pr, pt, pb))
    p = torch.nn.functional.unfold(xp, ks)
    p = p.transpose(1, 2).reshape(-1, p.shape[1])
    if bias:
        p = torch.cat([p, p.new_ones(p.shape[0], 1)], 1)
    return p.T @ p


def _off_err(got, ref):
    """The largest off-diagonal |got - ref| over the largest off-diagonal
    |ref|."""
    off = ~torch.eye(ref.shape[0], dtype=torch.bool, device=ref.device)
    return float((got.double() - ref)[off].abs().max()
                 / ref[off].abs().max())


def _tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits, to nearest)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


# -- the plan (CPU) -----------------------------------------------------------

@pytest.mark.parametrize("shape,ks,pad,bias", CORR_CASES)
def test_plan_in_plain_torch_matches_composition(shape, ks, pad, bias):
    """The plan's items, signs and window sums, run in float64, give the
    composition's Gram: 1e-6 of max|G| (the composition's f32 sums)."""
    x = _x((4,) + shape)
    plan = _plan((4,) + shape, ks, pad)
    _close(run_plan(x, plan, bias),
           tcorr.corr_patch_gram_plain(x, ks, pad, bias), 1e-6)


@pytest.mark.parametrize("shape,ks,pad,bias", CORR_CASES)
def test_plan_items_lie_in_the_image_with_non_negative_deltas(shape, ks,
                                                              pad, bias):
    """Every rectangle and its shift by delta read the image alone (no
    padding), delta is lexicographically non-negative, and a block's terms
    use its own delta; the delta-0 blocks use delta-0 items only."""
    h, w, _ = shape
    plan = _plan((4,) + shape, ks, pad)
    for dy, dx, y0, x0, rh, rw in plan.items:
        assert (dy, dx) >= (0, 0) and rh > 0 and rw > 0
        for oy, ox in ((0, 0), (dy, dx)):
            assert 0 <= y0 + oy and y0 + oy + rh <= h
            assert 0 <= x0 + ox and x0 + ox + rw <= w
    kw = ks[1]
    for (t, t2), terms in plan.terms.items():
        assert t <= t2
        for item, sign in terms:
            assert sign in (1, -1)
            assert plan.items[item][:2] == (t2 // kw - t // kw,
                                            t2 % kw - t % kw)


@pytest.mark.parametrize("shape,ks,pad", [
    ((128, 28, 28, 128), (3, 3), "SAME"),
    ((128, 14, 14, 256), (3, 3), "SAME"),
    ((4, 48, 48, 64), (3, 3), "SAME"),
    ((2, 10, 10, 200), (5, 5), "SAME"),
    ((3, 3, 8, 3), (5, 5), ((2, 2), (2, 2))),
])
@pytest.mark.parametrize("slots", [132, 264])
def test_plan_blocks_cover_each_item_once(shape, ks, pad, slots):
    """Each item's (tile, split) pairs appear once among the blocks, its
    splits cover its tokens with at most MAX_CHAIN_TOKENS each, the slots
    number them without gaps, and the blocks run longest first."""
    b = shape[0]
    plan = _plan(shape, ks, pad, slots)
    seen = {}
    for item, ti, tj, split in plan.blocks:
        key = (item, ti, tj, split)
        assert key not in seen
        seen[key] = True
    for i, rect in enumerate(plan.items):
        tokens = b * rect[4] * rect[5]
        assert plan.per_split[i] <= launch.MAX_CHAIN_TOKENS
        assert plan.per_split[i] * plan.splits[i] >= tokens
        assert plan.per_split[i] * (plan.splits[i] - 1) < tokens
        want = {(i, ti, tj, s) for ti, tj in plan.item_tiles(i)
                for s in range(plan.splits[i])}
        assert want <= set(seen)
    assert len(seen) == plan.slots == sum(
        len(plan.item_tiles(i)) * plan.splits[i]
        for i in range(len(plan.items)))
    assert list(plan.base) == sorted(plan.base)
    per = [plan.per_split[blk[0]] for blk in plan.blocks]
    assert per == sorted(per, reverse=True)


@pytest.mark.parametrize("shape", [(128, 28, 28, 128), (128, 14, 14, 256)])
def test_plan_at_resnet50_shapes(shape):
    """3x3 SAME: one full field per delta of the positive half (13), and
    the boundary rectangles only where a window ends inside the image (the
    all-padding rows and columns have none); the blocks fill the card's
    132 slots in at most two waves of chains under the cap."""
    plan = _plan(shape, (3, 3), "SAME")
    h = shape[1]
    full = [r for r in plan.items
            if r[4] == h - abs(r[0]) and r[5] == h - abs(r[1])]
    assert len({r[:2] for r in full}) == len(full) == 13
    assert all(min(r[4], r[5]) == 1 for r in plan.items if r not in full)
    assert len(plan.items) == 29
    assert len(plan.blocks) <= 2 * 132 + 40


def test_table_layout():
    """The device table holds items, blocks, ranges and terms at the
    offsets the launch passes."""
    plan = _plan((2, 8, 8, 3), (3, 3), "SAME")
    table = plan.table()
    items, blocks, ranges, terms = plan.offsets()
    assert table.dtype == np.int32
    n_terms = sum(len(v) for v in plan.terms.values())
    assert table.size == terms + 2 * n_terms
    assert blocks - items == len(plan.items) * len(ccg.ITEM_FIELDS)
    assert ranges - blocks == len(plan.blocks) * len(ccg.BLOCK_FIELDS)
    first = table[:len(ccg.ITEM_FIELDS)]
    assert tuple(first[:6]) == plan.items[0]
    assert first[ccg.ITEM_FIELDS.index("tokens")] == 2 * first[4] * first[5]
    rng = table[ranges:terms].reshape(-1, 2)
    for (t, t2), lst in plan.terms.items():
        lo, hi = rng[t * plan.taps + t2]
        assert hi - lo == len(lst)
        assert [tuple(p) for p in table[terms:].reshape(-1, 2)[lo:hi]] \
            == list(lst)


@pytest.mark.parametrize("shape,ks,pad", CUDA_CASES[:-2])
def test_off_diagonal_bar_refuses_lower_precisions(shape, ks, pad):
    """OFF_RTOL, the card tests' bar, fails the Gram of operands rounded
    to TF32 (a single TF32 pass) or to bf16, and passes the f32
    composition, on the card tests' shapes (ResNet-50's two at B=16
    aside: float64 Grams too slow here)."""
    x = _x(shape)
    ref = _gram64(x, ks, pad)
    assert _off_err(tcorr.corr_patch_gram_plain(x, ks, pad), ref) \
        <= OFF_RTOL / 4
    for low in (_tf32(x), x.bfloat16()):
        assert _off_err(_gram64(low, ks, pad), ref) > 10 * OFF_RTOL


# -- contract and dispatch (CPU) ----------------------------------------------

@pytest.mark.parametrize("make,exc", [
    (lambda: _x((2, 5, 5, 4)).double(), TypeError),
    (lambda: _x((2, 5, 5, 4)).half(), TypeError),
    (lambda: _x((2, 5, 5, 4)).int(), TypeError),
    (lambda: _x((5, 5, 4)), ValueError),
    (lambda: _x((2, 1, 5, 5, 4)), ValueError),
    (lambda: _x((2, 4, 5, 5)).permute(0, 2, 3, 1), ValueError),
    (lambda: _x((2, 5, 10, 4))[:, :, ::2], ValueError),
])
def test_contract_checks_raise(make, exc):
    """A dtype other than f32 or bf16, a shape other than NHWC, or NHWC
    strides other than contiguous are refused, on any device."""
    with pytest.raises(exc):
        ccg.corr_gram(make(), (3, 3))


def test_contract_refuses_an_empty_window():
    with pytest.raises(ValueError):
        ccg.corr_gram(_x((2, 2, 5, 4)), (3, 3), ((0, 0), (1, 1)))
    with pytest.raises(ValueError):
        ccg.corr_gram(_x((2, 5, 5, 4)), (0, 3))


@pytest.mark.parametrize("device,groups,want", [
    ("cpu", 1, False), ("cpu", 2, False), ("cuda", 1, True),
    ("cuda", 2, False), ("cuda", 4, False), ("meta", 1, False)])
def test_dispatch_takes_the_kernel_for_one_group_on_cuda(device, groups,
                                                         want, monkeypatch):
    """Only a CUDA tensor of one group goes to the kernel; the grouped
    route and every CPU tensor keep the composition."""
    took = []
    monkeypatch.setattr(tcorr, "corr_gram",
                        lambda *a, **k: took.append("kernel"))
    monkeypatch.setattr(tcorr, "corr_patch_gram_plain",
                        lambda *a, **k: took.append("plain"))
    x = types.SimpleNamespace(device=torch.device(device),
                              dtype=torch.float32)
    x.contiguous = lambda: x
    tcorr.corr_patch_gram(x, (3, 3), "SAME", True, groups)
    assert took == ["kernel" if want else "plain"]


@pytest.mark.parametrize("groups", [1, 2])
def test_cpu_calls_compute_the_composition_and_launch_nothing(groups):
    x = _x((2, 6, 6, 4))
    before = ccg.corr_gram.launches
    want = tcorr.corr_patch_gram_plain(x, (3, 3), "SAME", True, groups)
    assert torch.equal(tcorr.corr_patch_gram(x, (3, 3), "SAME", True,
                                             groups), want)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ccg.corr_gram(x, (3, 3), "SAME")
    assert ccg.corr_gram.launches == before


def test_kfac_corr_route_and_span_name_unchanged():
    """The gate and the route name are the composition's: the same layers
    take ``corr``."""
    est = port_est.KFAC(_two_corr_net(), use_kernels=False,
                        **_CORR_GATE)
    routes = {m.name: est.a_route(
        m, (2, 8, 8, m.fan_in // (m.kernel_size[0] * m.kernel_size[1])), 4)
        for m in est.metas.values() if m.kind == "conv"}
    assert routes == {"c1": "patches", "c2": "corr", "c3": "corr"}


# -- on the card --------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape,ks,pad", CUDA_CASES)
def test_cuda_kernel_matches_composition(shape, ks, pad, bias, dtype):
    """Within 1e-4 of max|G| of the composition and within OFF_RTOL of
    the float64 Gram's off-diagonal on the card, two launches a call, the
    same bits from a second call."""
    _needs_card()
    x = _x(shape, dtype=getattr(torch, dtype), device="cuda")
    before = ccg.corr_gram.launches
    got = ccg.corr_gram(x, ks, pad, bias)
    torch.cuda.synchronize()
    assert ccg.corr_gram.launches - before == 2
    assert torch.equal(got, ccg.corr_gram(x, ks, pad, bias))
    want = tcorr.corr_patch_gram_plain(x, ks, pad, bias)
    assert torch.isfinite(got).all()
    _close(got.cpu(), want.cpu(), 1e-4)
    assert _off_err(got, _gram64(x, ks, pad, bias)) <= OFF_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scalar_loads_on_a_misaligned_view(dtype):
    """A contiguous view one element into its storage takes the scalar
    loads and computes the same Gram."""
    _needs_card()
    shape = (2, 9, 9, 64)
    flat = _x((int(np.prod(shape)) + 1,), dtype=getattr(torch, dtype),
              device="cuda")
    x = flat[1:].view(shape)
    assert not ccg.vector_gather(x)
    got = ccg.corr_gram(x, (3, 3), "SAME")
    _close(got.cpu(), tcorr.corr_patch_gram_plain(x, (3, 3), "SAME").cpu(),
           1e-4)
    assert _off_err(got, _gram64(x, (3, 3), "SAME")) <= OFF_RTOL


_CORR_GATE = dict(corr_gram_min_channels=8, corr_gram_min_extent=1)


def _two_corr_net():
    """Two 3x3 convs over 16 channels (``c2``, ``c3``) behind a 3-channel
    one (``c1``, below the opened gate's 8 channels)."""
    tm = tnn.Sequential([tnn.Conv(3, 16, 3, padding=1, name="c1"),
                         tnn.ReLU(),
                         tnn.Conv(16, 16, 3, padding=1, name="c2"),
                         tnn.ReLU(),
                         tnn.Conv(16, 16, 3, padding=1, name="c3"),
                         tnn.ReLU(), tnn.Flatten(),
                         tnn.Dense(16 * 8 * 8, 10, name="fc")])
    tmodels.load_jax_variables(tm, tmodels.seeded_variables(tm, 0))
    return tm


@pytest.mark.cuda
def test_cuda_kfac_update_matches_cpu():
    """A KFAC.update of the two-corr-layer net on the card holds the CPU
    state (A to 1e-5, G to 1e-4 of max, strict f32 on both), with at most
    3 corr_gram launches a corr layer an update."""
    _needs_card()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, 8, 8, generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    states = {}
    for device in ("cpu", "cuda"):
        est = port_est.KFAC(_two_corr_net().to(device), **_CORR_GATE)
        before = ccg.corr_gram.launches
        for _ in range(2):
            est.update(x.to(device), labels=y.to(device))
        launches = ccg.corr_gram.launches - before
        if device == "cuda":
            torch.cuda.synchronize()
            assert 0 < launches <= 3 * 2 * 2, launches
        else:
            assert launches == 0
        states[device] = est.state
    for name, fac in states["cpu"].items():
        got = states["cuda"][name]
        _close(got["a"].cpu(), fac["a"], 1e-5)
        _close(got["g"].cpu(), fac["g"], 1e-4)
