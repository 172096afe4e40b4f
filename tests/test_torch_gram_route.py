"""The batched symmetric Gram (``ops/cuda/sym_gram.sym_gram_batched``) and
KFAC's one route to it, ``estimators/grams.factor_gram``: the kernel's
plain version and its pre-pass's layout over uniform, ragged, empty,
strided and ones-column segments, checked per segment against
``sym_gram_plain`` and a float64 ``a^T a``; the gate from shape alone; the
seam's decision and the ones column it appends; the ``gram`` attribute of
the ``factor`` spans; the routed and stacked routes through the batched
entry against the matmul route; and, on the card only, the kernel at the
fit cells' shapes against a float64 Gram."""
import math

import numpy as np
import pytest
import torch

from curvature_tpu_torch import estimators as est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.estimators import grams as tgrams
from curvature_tpu_torch.ops.cuda import launch
from curvature_tpu_torch.ops.cuda import sym_gram as tsg
from curvature_tpu_torch.utils import monitor

torch.set_num_threads(1)

#: f32 summation over a few thousand rows: well inside 1e-5 of max|G|
F32_REL = 1e-5
#: the card's bar off the diagonal, of the largest entry of a float64
#: Gram (CORR_OFF_RTOL of tests/test_torch_corr_gram.py): a single TF32
#: pass misses it
OFF_RTOL = 1e-5


def _rows(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _gram64(t, ones=False):
    t = t.double()
    if ones:
        t = torch.cat([t, t.new_ones(t.shape[:-1] + (1,))], -1)
    return t.T @ t


def _close(got, want, rel=F32_REL):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max())
    assert err <= rel * scale, (err / scale, rel)


#: (name, x, offsets, ones): a segment's rows not a multiple of 32, F odd
#: and not a multiple of 128, an empty segment, a transposed view, and the
#: ones column
CASES = {
    "uniform": ((3, 100, 130), None, False),
    "uniform-ones": ((2, 70, 129), None, True),
    "ragged": ((211, 77), [0, 33, 33, 140, 211], False),
    "ragged-ones": ((90, 64), [0, 1, 64, 90], True),
    "one-segment": ((45, 257), [0, 45], False),
}


def _case(name):
    shape, offsets, ones = CASES[name]
    return _rows(shape, len(name)), offsets, ones


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_plain_is_per_segment_sym_gram_plain(name):
    """Every segment's Gram is its own ``sym_gram_plain`` (the ones column
    appended first) and its float64 ``a^T a`` within f32 rounding; an
    empty segment's is exactly zero."""
    x, offsets, ones = _case(name)
    got = tsg.sym_gram_batched(x, offsets, ones)
    segs = tsg.segments_of(x, offsets)
    f = x.shape[-1] + ones
    assert got.shape == ((len(segs),) if offsets else x.shape[:-2]) + (f, f)
    for g, t in zip(got.reshape(-1, f, f), segs):
        want = tsg.sym_gram_plain(tsg._with_ones(t, ones))
        assert torch.equal(g, want)
        assert torch.equal(g, g.T)
        if t.shape[0] == 0:
            assert not g.any()
        else:
            _close(g, _gram64(t, ones))


def test_batched_plain_reads_a_transposed_view():
    """A grouped layer's ``[N, g, cols]`` tokens read as ``[g, N, cols]``
    through a transposed view: the same Grams as its contiguous copy."""
    t = _rows((50, 3, 40), 1).transpose(0, 1)
    assert not t.is_contiguous()
    got = tsg.sym_gram_batched(t)
    assert torch.equal(got, tsg.sym_gram_batched(t.contiguous()))
    for g, s in zip(got, t):
        _close(g, _gram64(s))


def test_batched_rejects_bad_offsets():
    x = _rows((10, 4))
    for offsets in ([0, 5], [1, 10], [0, 6, 5, 10], [0]):
        with pytest.raises(ValueError):
            tsg.sym_gram_batched(x, offsets)
    with pytest.raises(ValueError):
        tsg.sym_gram_batched(_rows((2, 10, 4)), [0, 10])


def _unswizzle(op):
    """[2, chunks, blocks, 64, 8, 4] slabs -> [2, features, rows]: quad j
    of feature row r of a slab stands at position j ^ (r % 8)."""
    r = torch.arange(64).view(64, 1)
    j = torch.arange(8).view(1, 8)
    two, nc, fb = op.shape[:3]
    un = op[:, :, :, r, j ^ (r % 8), :]
    return un.permute(0, 2, 3, 1, 4, 5).reshape(two, fb * 64, nc * 32)


def test_cpu_batched_presplit_is_its_plain_version_and_counts_none():
    """On the CPU the public pre-pass keeps its 2-D contract (its plain
    version, no launch counted); the batched pre-pass's plain version is
    each segment's, the ones column appended first, end to end."""
    x, offsets, ones = _case("ragged-ones")
    before = tsg.tf32_presplit.launches
    assert torch.equal(tsg.tf32_presplit(x), tsg.tf32_presplit_plain(x))
    assert tsg.tf32_presplit.launches == before
    with pytest.raises(TypeError):
        tsg.tf32_presplit(x[None])
    want = torch.cat([tsg.tf32_presplit_plain(tsg._with_ones(t, ones))
                      for t in tsg.segments_of(x, offsets)], 1)
    assert torch.equal(tsg.tf32_presplit_batched_plain(x, offsets, ones),
                       want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_presplit_layout_and_arithmetic(name):
    """The batched pre-pass's plain version: each segment in whole chunks
    of CHUNK rows from its own chunk base (none straddles two segments,
    an empty segment has none), zero past its rows and past F, the ones
    column exactly 1 on its rows; and the kernel's three TF32 products
    (lo*hi + hi*lo + hi*hi) over a segment's chunks give its float64 Gram
    within the card's bar."""
    x, offsets, ones = _case(name)
    segs = tsg.segments_of(x, offsets)
    f = x.shape[-1] + ones
    op = tsg.tf32_presplit_batched_plain(x, offsets, ones)
    chunks = [-(-t.shape[0] // tsg.CHUNK) for t in segs]
    assert op.shape == (2, sum(chunks)) + tsg.presplit_shape(1, f)[2:]
    hi, lo = _unswizzle(op).double()
    c0 = 0
    for t, nc in zip(segs, chunks):
        rows = slice(c0 * tsg.CHUNK, (c0 + nc) * tsg.CHUNK)
        h, l = hi[:, rows], lo[:, rows]
        n = t.shape[0]
        assert not h[:, n:].any() and not h[f:].any() and not l[f:].any()
        if ones:
            assert torch.equal(h[f - 1, :n], torch.ones(n, dtype=h.dtype))
            assert not l[f - 1].any()
        want = _gram64(t, ones)
        got = h @ l.T + l @ h.T + h @ h.T
        _close(got[:f, :f], want, OFF_RTOL / 10)
        c0 += nc


@pytest.mark.parametrize("segments,rows,f,want", [
    (12, 12 * 8192, 769, True),           # GPT-2's stacked A
    (12, 12 * 8192, 3072, True),
    (16, 12288, 2048, True),              # a Moonlight routed side
    (1, 8192, 11264, True),
    (1, 8192, 576, True),                 # Moonlight's kv_a_proj G
    (1, 8192, 256, False),                # lost on the card: 0.68x
    (1, 401408, 256, True),               # ResNet-50 layer1's 1x1 A
    (1, 401408, 64, False),
    (1, 128, 1000, False),                # ResNet-50's fc G at B=128
    (1, 128, 1024, False),                # lost on the card: 0.62x
    (1, 128, 2049, False),                # ResNet-50's fc A at B=128
    (16, 16 * 768, 256, False),           # a tie on the card
    (1, 4000, 775, True),                 # just past GATE_WORK
    (1, 4000, 774, False),
    (1, 2 ** 20, 127, False),             # under one output tile
    (1, 128, 2048, False),                # lost back to back on the card
    (1, 512, 2048, False),                # a tie back to back
    (16, 16 * 256, 769, True),            # won on both
    (0, 0, 2048, False),
])
def test_gate_from_shape_alone(segments, rows, f, want):
    """The gate reads (segments, rows, F) and nothing else: work (rows *
    F^2) past GATE_WORK at F >= F32_TILE."""
    assert tsg.batched_gate(segments, rows, f) is want


def test_route_takes_sym_only_on_cuda_f32_with_kernels():
    """The seam's decision (``grams.takes_kernel``): a CPU tensor, bf16
    operands, a bf16 Gram or ``use_kernels=False`` always take the matmul,
    whatever the shape, and so does a CPU Gram's label."""
    a = torch.empty((12, 8192, 769), device="meta")
    ok = (12, 12 * 8192, 769)
    assert not tgrams.takes_kernel(torch.empty(1, 1), torch.float32, True,
                                   ok)
    assert not tgrams.takes_kernel(a, torch.float32, False, ok)
    assert not tgrams.takes_kernel(a.bfloat16(), torch.float32, True, ok)
    assert not tgrams.takes_kernel(a, torch.bfloat16, True, ok)
    assert tgrams.gram_label(torch.empty(12, 8192, 768), torch.float32,
                             True, ones=True) == {"gram": "matmul"}


def _force_kernel(monkeypatch, calls=None):
    """Forces the seam's decision open, its kernel the plain
    ``sym_gram_batched_plain``, each call's (shape, offsets, ones) kept in
    ``calls``."""
    def plain(a, offsets=None, ones=False):
        if calls is not None:
            calls.append((tuple(a.shape), offsets, ones))
        return tsg.sym_gram_batched_plain(a, offsets, ones)
    monkeypatch.setattr(tgrams, "takes_kernel", lambda *a, **k: True)
    monkeypatch.setattr(tgrams, "sym_gram_batched", plain)


#: (input shape, view, offsets) of ``factor_gram``: [n, F] tokens, a
#: grouped layer's [N, g, F] tokens read as [g, N, F] through a
#: transposed view, and [S, R, F] rows cut at host offsets (an empty
#: segment among them)
ONES_CASES = {
    "2d": ((70, 9), None, None),
    "transposed": ((40, 3, 7), (1, 0, 2), None),
    "offsets": ((2, 30, 6), None, [0, 11, 11, 30]),
}


@pytest.mark.parametrize("kernel", [False, True], ids=["matmul", "kernel"])
@pytest.mark.parametrize("name", sorted(ONES_CASES))
def test_factor_gram_appends_the_ones_column(name, kernel, monkeypatch):
    """``factor_gram(t, ones=True)`` is the Gram of ``cat([t, 1])``: on the
    matmul path (float64 in, float64 Gram) to float64 rounding, and with
    the kernel decision forced to the plain ``sym_gram_batched_plain``
    (f32 sums) within f32 rounding; one Gram a leading index, or one a
    segment of the S samples' rows."""
    shape, perm, offsets = ONES_CASES[name]
    t = _rows(shape, len(name)).double()
    if perm:
        t = t.permute(perm)
    if kernel:
        _force_kernel(monkeypatch)
    got = tgrams.factor_gram(t, torch.float64, kernel, ones=True,
                             offsets=offsets)
    if offsets is None:
        segs = list(t.reshape((-1,) + t.shape[-2:]))
    else:
        segs = [t[:, a:b].reshape(-1, t.shape[-1])
                for a, b in zip(offsets, offsets[1:])]
    f = t.shape[-1] + 1
    assert got.shape == ((len(segs),) if offsets else t.shape[:-2]) + (f, f)
    for g, seg in zip(got.reshape(-1, f, f), segs):
        want = _gram64(seg, ones=True)
        assert want[-1, -1] == seg.shape[0]
        _close(g, want, F32_REL if kernel else 1e-12)


def _gpt():
    torch.manual_seed(0)
    model = tmodels.gpt2_custom(64, 32, 2, 2, 16, True, "cpu")
    x = torch.randint(0, 64, (2, 16))
    labels = torch.randint(0, 64, (1, 2, 16))
    return model, x, labels


def _moe():
    torch.manual_seed(1)
    moe = tnn.MoE(16, 16, 4, hidden=24, top_k=2, name="moe",
                  scoring="sigmoid", gated=True, norm_topk_prob=True,
                  routed_scale=1.7)
    model = tnn.Sequential([tnn.Dense(8, 16, name="inp"), tnn.ReLU(), moe,
                            tnn.Dense(16, 5, name="head")])
    return model, torch.randn(32, 8), torch.randint(0, 5, (2, 32))


def _kfac(model, x, labels, **kw):
    k = est.KFAC(model, **kw)
    with monitor.tracing():
        monitor.clear_spans()
        k.update(x, labels=labels)
        spans = [s for s in monitor.spans() if s.name == "factor"]
    monitor.clear_spans()
    return k, spans


@pytest.mark.parametrize("which", ["gpt", "moe"])
def test_factor_spans_carry_gram(which):
    """On the CPU every ``factor`` span carries ``gram``, and every Gram
    is a matmul."""
    model, x, labels = _gpt() if which == "gpt" else _moe()
    kw = {"loss": "lm"} if which == "gpt" else {}
    _, spans = _kfac(model, x, labels, **kw)
    assert spans
    assert {s.attrs["gram"] for s in spans} == {"matmul"}


@pytest.mark.parametrize("which", ["gpt", "moe"])
def test_batched_route_equals_the_matmul_route(which, monkeypatch):
    """With the seam's decision forced open, the stacked and plain routes
    (every bias's ones column from the pre-pass) and the routed route (all
    held experts in one ragged call, the S = 2 samples' rows made
    adjacent) go through ``sym_gram_batched`` (its plain version here) and
    give the matmul route's factors within f32 rounding; each such span
    says ``sym``, a routed layer-side is one call."""
    model, x, labels = _gpt() if which == "gpt" else _moe()
    kw = {"loss": "lm"} if which == "gpt" else {}
    want, _ = _kfac(model, x, labels, **kw)
    calls = []
    _force_kernel(monkeypatch, calls)
    got, spans = _kfac(model, x, labels, **kw)
    assert {s.attrs["gram"] for s in spans} == {"sym"}
    assert len(calls) == len(spans)
    assert sum(ones for _, _, ones in calls) == sum(
        m.has_bias for m in got.metas.values())
    if which == "gpt":
        assert {o for _, o, _ in calls} == {None}
    else:
        routed = [c for c in calls if c[1] is not None]
        assert len(routed) == 2 * 3                      # 3 experts' layers
        for shape, offsets, _ in routed:
            assert len(offsets) == 4 + 1 and offsets[-1] == shape[0]
    for name in want.state:
        for key in want.state[name]:
            _close(got.state[name][key], want.state[name][key])


def test_sym_spans_carry_gram_shape_and_stack_grams_its_buckets(
        monkeypatch):
    """With the seam's decision forced open: a ``sym`` factor span carries
    its Gram's (segments, rows, F), and with ``stack_grams`` each bucket is
    one call whose (layers, rows, F) the ``stack_grams`` span lists, its
    layers' spans saying ``sym``; the factors equal the matmul route's."""
    torch.manual_seed(2)
    model = tnn.Sequential([tnn.Dense(8, 16, name="d0"), tnn.ReLU(),
                            tnn.Dense(16, 16, name="d1"), tnn.ReLU(),
                            tnn.Dense(16, 16, name="d2"), tnn.ReLU(),
                            tnn.Dense(16, 5, name="d3")])
    x, labels = torch.randn(24, 8), torch.randint(0, 5, (1, 24))
    want, _ = _kfac(model, x, labels, stack_grams=True)
    _force_kernel(monkeypatch)
    got, _ = _kfac(model, x, labels)
    with monitor.tracing():
        monitor.clear_spans()
        stacked = est.KFAC(model, stack_grams=True)
        stacked.update(x, labels=labels)
        spans = monitor.spans()
    monitor.clear_spans()
    buckets = [s for s in spans if s.name == "stack_grams"]
    assert len(buckets) == 1
    assert sorted(buckets[0].attrs["gram_shapes"]) == [(3, 72, 16),
                                                       (3, 72, 17)]
    for s in spans:
        if s.name != "factor":
            continue
        assert s.attrs["gram"] == "sym"
        if s.attrs["route"] != "stack_grams":
            segments, rows, f = s.attrs["gram_shape"]
            assert (segments, rows, f) in ((1, 24, 9), (1, 24, 5))
    for k in (got, stacked):
        for name in want.state:
            for key in want.state[name]:
                _close(k.state[name][key], want.state[name][key])


def test_routed_sym_pairs_samples_rows():
    """The routed G's S samples go in as one expert-sorted row matrix: the
    rows of expert e for every sample at ``S * offsets[e]`` on."""
    g = _rows((3, 7, 5), 2)
    offsets = [0, 2, 2, 7]
    rows = g.transpose(0, 1).reshape(-1, 5)
    got = tsg.sym_gram_batched(rows, [3 * o for o in offsets])
    for e in range(3):
        seg = g[:, offsets[e]:offsets[e + 1]].reshape(-1, 5)
        _close(got[e], _gram64(seg))


# -- on the card ---------------------------------------------------------

def _routed_lengths(total=12288, n=16, lo=330, hi=1583, seed=0):
    """``n`` segment lengths in [lo, hi] summing to ``total``."""
    rng = np.random.default_rng(seed)
    while True:
        w = rng.uniform(lo, hi, n)
        lens = np.floor(w / w.sum() * total).astype(int)
        lens[-1] += total - lens.sum()
        if lens.min() >= lo and lens.max() <= hi:
            return lens.tolist()


CARD_CASES = {
    "gpt2-a-769": ((12, 8192, 768), None, True),
    "gpt2-a-3073": ((12, 8192, 3072), None, True),
    "moonlight-dense-a": ((8192, 11264), None, False),
    "moonlight-routed": ((12288, 2048), "routed", False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_cuda_batched_kernel_at_cell_shapes(name):
    """The kernel on the card at the fit cells' shapes: the pre-pass bit
    for bit against its plain version, one launch, bitwise symmetric and
    repeatable, and off the diagonal within OFF_RTOL of the largest entry
    of a float64 Gram."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, offsets, ones = CARD_CASES[name]
    x = _rows(shape, 3).cuda()
    if offsets == "routed":
        offsets = np.concatenate([[0], np.cumsum(_routed_lengths())]).tolist()
    before = tsg.sym_gram_batched.launches
    got = tsg.sym_gram_batched(x, offsets, ones)
    assert tsg.sym_gram_batched.launches == before + 1
    assert torch.equal(got, tsg.sym_gram_batched(x, offsets, ones))
    f = got.shape[-1]
    got = got.reshape(-1, f, f)
    assert torch.equal(got, got.mT)
    segs = tsg.segments_of(x, offsets)
    with torch.cuda.device(x.device):
        _, op = next(tsg._presplits(x, offsets, ones))
    assert torch.equal(op, tsg.tf32_presplit_batched_plain(x, offsets, ones))
    eye = torch.eye(f, dtype=torch.bool, device=x.device)
    for g, t in zip(got, segs):
        want = _gram64(t, ones)
        off = float((g.double() - want).abs().masked_fill(eye, 0).max())
        assert off <= OFF_RTOL * float(want.abs().max()), name


@pytest.mark.cuda
def test_cuda_batched_kernel_launches_a_slice_of_max_segments():
    """More segments than one launch's table: one launch a slice of
    MAX_SEGMENTS, each Gram its plain version's within f32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    x = _rows((tsg.MAX_SEGMENTS + 2, 100, 40), 4).cuda()
    before = tsg.sym_gram_batched.launches
    got = tsg.sym_gram_batched(x, ones=True)
    assert tsg.sym_gram_batched.launches == before + 2
    want = tsg.sym_gram_batched_plain(x.cpu(), ones=True)
    for g, w in zip(got.cpu(), want):
        _close(g, w)


@pytest.mark.cuda
def test_cuda_kfac_update_takes_the_kernel_and_matches_matmul():
    """A KFAC update of a stacked GPT-2 on the card, at a width whose 8
    factor Grams all pass the gate: each launches the kernel (one launch
    a factor), and the state equals ``use_kernels=False``'s within f32
    rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = tmodels.gpt2_custom(512, 1024, 2, 8, 1024, True, "cuda")
    x = torch.randint(0, 512, (4, 1024), device="cuda")
    labels = torch.randint(0, 512, (1, 4, 1024), device="cuda")
    assert tsg.batched_gate(2, 2 * 4 * 1024, 1024)
    before = tsg.sym_gram_batched.launches
    got, spans = _kfac(model, x, labels, loss="lm", layer_filter="h.*")
    want, _ = _kfac(model, x, labels, loss="lm", layer_filter="h.*",
                    use_kernels=False)
    syms = sum(s.attrs["gram"] == "sym" for s in spans)
    assert syms == 8
    assert tsg.sym_gram_batched.launches == before + syms
    for name in want.state:
        for key in want.state[name]:
            _close(got.state[name][key], want.state[name][key])


def test_split_plan_counts_every_segment_tiles():
    """A batched launch's plan counts the block tiles of all its
    segments: 12 GPT-2 depths at F = 769 fill 132 slots in one pass; one
    such segment alone is split to fill them; a segment's chain cap
    holds whatever the batch."""
    assert tsg.split_plan(8192, 769, False, 132, 12) == (1, 8192)
    splits, per = tsg.split_plan(8192, 769, False, 132, 1)
    assert splits > 1 and per % tsg.CHUNK == 0
    assert tsg.split_plan(16384, 4609, False, 132, 3)[1] \
        <= launch.MAX_CHAIN_TOKENS
    assert tsg.split_plan(0, 2048, False, 132, 16) == (1, tsg.CHUNK)
    assert math.prod(tsg.split_plan(1583, 2048, False, 132, 16)) >= 1583
