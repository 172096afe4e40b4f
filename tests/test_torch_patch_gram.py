"""Port parity: the patch-Gram entry points of ``curvature_tpu_torch``
(``patch_gram_tiled``, ``patch_gram_v2``, ``patch_gram``; f32 and bf16)
against the JAX Pallas functions (interpret mode), and the dispatch
policy and gates against the JAX ones.

On the CPU the port's wrappers compute their plain PyTorch versions; the
CUDA kernels are held against those plain versions by the ``cuda``-marked
test below, which skips where there is no card.
"""
import importlib

import numpy as np
import pytest
import torch

from curvature_tpu_torch.ops.cuda import launch
from curvature_tpu_torch.ops.cuda import patch_gram as tpg

try:
    import jax.numpy as jnp
    # the package re-exports a function named patch_gram over the module
    jpg = importlib.import_module("curvature_tpu.ops.pallas.patch_gram")
except ImportError:
    # the card's machine has no JAX: only the cuda-marked tests run there
    # (python -m pytest tests/test_torch_patch_gram.py --noconftest -m cuda)
    jnp = jpg = None

torch.set_num_threads(1)

#: tests/test_pallas_kernels.py:41-45 (stride 1) and :55-62 (stride 2)
V2_CASES = [
    ((2, 8, 8, 4), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((3, 10, 6, 8), (3, 3), ((0, 0), (0, 0)), (1, 1)),
    ((2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ((2, 8, 8, 4), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ((3, 9, 9, 8), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ((2, 10, 6, 8), (3, 3), ((0, 0), (0, 0)), (2, 2)),
    ((2, 12, 12, 4), (5, 5), ((2, 2), (2, 2)), (2, 2)),
    ((2, 8, 8, 4), (3, 3), "SAME", (2, 2)),
    ((2, 7, 9, 4), (3, 3), "SAME", (2, 2)),
]

#: strides outside (1, 1) and (2, 2): the JAX parity stack computes them
#: (patch_gram.py:251-268), the CUDA kernel through its run-time-stride
#: instance
RT_STRIDE_CASES = [
    ((2, 9, 9, 4), (3, 3), ((1, 1), (1, 1)), (3, 3)),
    ((2, 8, 8, 4), (3, 3), ((1, 1), (1, 1)), (1, 2)),
    ((2, 8, 8, 4), (3, 3), ((1, 1), (1, 1)), (2, 1)),
]

#: tests/test_pallas_kernels.py:20-25 (stride 1 only)
PG_CASES = [
    ((2, 8, 8, 4), (3, 3), ((1, 1), (1, 1))),
    ((3, 10, 6, 8), (3, 3), ((0, 0), (0, 0))),
    ((2, 7, 7, 4), (5, 5), ((2, 2), (2, 2))),
    ((1, 9, 9, 3), (2, 2), ((0, 0), (0, 0))),
]

#: tests/test_pallas_kernels.py:94-101
TILED_CASES = [
    ((2, 14, 14, 256), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((2, 7, 7, 512), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((2, 16, 16, 64), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((2, 12, 12, 128), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ((2, 9, 9, 96), (3, 3), "SAME", (1, 1)),
    ((1, 10, 10, 32), (5, 5), ((2, 2), (2, 2)), (1, 1)),
]


def _assert_gram_close(got, want):
    """The JAX tests' bar: rtol 1e-4, atol 1e-4 * max|G| (f32 sums over
    up to a few thousand tokens in another order)."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("shape,ks,pad,strides", V2_CASES)
def test_patch_gram_v2_plain_matches_jax(shape, ks, pad, strides):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jpg.patch_gram_v2(jnp.asarray(x), ks, pad, strides,
                                        interpret=True))
    got = tpg.patch_gram_v2(torch.from_numpy(x), ks, pad, strides).numpy()
    _assert_gram_close(got, want)


@pytest.mark.parametrize("shape,ks,pad,strides", TILED_CASES)
def test_patch_gram_tiled_plain_matches_jax(shape, ks, pad, strides):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jpg.patch_gram_tiled(jnp.asarray(x), ks, pad, strides,
                                           interpret=True))
    got = tpg.patch_gram_tiled(torch.from_numpy(x), ks, pad,
                               strides).numpy()
    _assert_gram_close(got, want)


@pytest.mark.parametrize("shape,ks,pad", PG_CASES)
def test_patch_gram_plain_matches_jax(shape, ks, pad):
    """The stride-1 entry point, at the JAX test's bar (rtol and atol
    1e-4)."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jpg.patch_gram(jnp.asarray(x), ks, pad,
                                     interpret=True))
    got = tpg.patch_gram(torch.from_numpy(x), ks, pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c,ks,strides", [
    (64, (3, 3), (1, 1)), (64, (3, 3), (2, 2)), (512, (3, 3), (1, 1)),
    (64, (1, 1), (1, 1)), (133, (3, 3), (1, 1)), (134, (3, 3), (1, 1)),
    (3, (2, 2), (1, 1)),
])
def test_patch_gram_supported_gate_matches_jax(c, ks, strides):
    """The gate of tests/test_pallas_kernels.py:34, and both sides of its
    F+1 <= 1200 edge (C=133: 1198; C=134: 1207)."""
    assert tpg.patch_gram_supported(c, ks, strides) \
        == jpg.patch_gram_supported(c, ks, strides)


#: bf16 edges of the CUDA kernel's tensor-core gather, as chip_smoke.py
#: checks them on the card: C = 96 (64-feature tiles that straddle taps,
#: F = 864 not a multiple of 64, N = 162 not a multiple of the 64-token
#: stage), N = 25 (less than one stage), N = 784 (more than one split on
#: the card). C = 4 and C = 3 (the scalar gather) are among the cases above.
BF16_EDGE_CASES = [
    ((2, 9, 9, 96), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((1, 5, 5, 64), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((4, 28, 28, 64), (3, 3), ((1, 1), (1, 1)), (2, 2)),
]


def _bf16_pair(shape, seed=0):
    """Numpy normals rounded to bf16, fed identically to both packages."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("entry,shape,ks,pad,strides", [
    ("v2", *V2_CASES[0]), ("v2", *V2_CASES[4]), ("v2", *V2_CASES[8]),
    *[("patch_gram", *case, (1, 1)) for case in PG_CASES],
    *[("v2", *case) for case in BF16_EDGE_CASES],
])
def test_bf16_operands_match_jax(entry, shape, ks, pad, strides):
    """bf16 operands: exact products, f32 sums in both packages, so the
    bar is 1e-5 of max|want| (only the summation order differs)."""
    x, jx = _bf16_pair(shape)
    if entry == "v2":
        want = jpg.patch_gram_v2(jx, ks, pad, strides, interpret=True)
        got = tpg.patch_gram_v2(x, ks, pad, strides)
    else:
        want = jpg.patch_gram(jx, ks, pad, interpret=True)
        got = tpg.patch_gram(x, ks, pad)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,ks,pad,strides", RT_STRIDE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_gram_v2_any_stride_plain_matches_jax(shape, ks, pad, strides,
                                                    dtype):
    """The plain version at strides (3, 3), (1, 2) and (2, 1) against the
    JAX ``patch_gram_v2`` (interpret mode) within 1e-4 of max|G|; bf16
    operands are fed identically to both packages."""
    if dtype == "float32":
        x = np.random.default_rng(0).standard_normal(shape).astype(
            np.float32)
        xt, jx = torch.from_numpy(x), jnp.asarray(x)
    else:
        xt, jx = _bf16_pair(shape)
    want = np.asarray(jpg.patch_gram_v2(jx, ks, pad, strides,
                                        interpret=True))
    got = tpg.patch_gram_v2(xt, ks, pad, strides)
    assert got.dtype == torch.float32
    _assert_gram_close(got.numpy(), want)


def test_cpu_wrappers_do_not_count_launches():
    """The launch counters count kernel launches only; the plain version
    on a CPU tensor is not one."""
    fns = (tpg.patch_gram_tiled, tpg.patch_gram_v2, tpg.patch_gram)
    before = [fn.launches for fn in fns]
    x = torch.zeros(1, 8, 8, 64)
    tpg.patch_gram_tiled(x, (3, 3), ((1, 1), (1, 1)))
    tpg.patch_gram_v2(x, (3, 3), ((1, 1), (1, 1)), (2, 2))
    tpg.patch_gram(x.bfloat16(), (3, 3), "SAME")
    assert [fn.launches for fn in fns] == before


def test_bf16_gather_is_chosen_by_shape_and_alignment():
    """The 16-byte gather where a pixel's channels are a multiple of 16
    bytes (bf16: C % 8 == 0; f32: C % 4 == 0) and the data is 16-byte
    aligned; the scalar one otherwise (bf16 C = 4, f32 C = 6, or a view 2
    or 4 bytes into its storage)."""
    x = torch.zeros(2, 8, 8, 64, dtype=torch.bfloat16)
    assert tpg.gather_kind(x) == "vector"
    assert tpg.gather_kind(torch.zeros(2, 8, 8, 4,
                                       dtype=torch.bfloat16)) == "scalar"
    shifted = torch.zeros(2 * 8 * 8 * 64 + 1, dtype=torch.bfloat16)[1:]
    assert tpg.gather_kind(shifted.view(2, 8, 8, 64)) == "scalar"
    assert tpg.gather_kind(torch.zeros(2, 8, 8, 4)) == "vector"
    assert tpg.gather_kind(torch.zeros(2, 8, 8, 6)) == "scalar"
    shifted = torch.zeros(2 * 8 * 8 * 64 + 1)[1:]
    assert tpg.gather_kind(shifted.view(2, 8, 8, 64)) == "scalar"


@pytest.mark.parametrize("f,bf16,tiles", [(576, False, 15), (576, True, 15),
                                          (1152, True, 45), (100, True, 1),
                                          (1152, False, 45), (100, False, 1)])
def test_block_tiles_follow_the_tile_edge(f, bf16, tiles):
    """F32_TILE-feature tiles for f32, BF16_TILE-feature tiles for bf16:
    both kernels run 128x128 tiles of two warpgroups."""
    assert tpg.F32_TILE == tpg.BF16_TILE == 128
    assert tpg.block_tiles(f, bf16) == tiles


@pytest.mark.parametrize("n_tokens", [25, 784, 25_088, 50_176, 400_000])
def test_bf16_splits_bound_each_accumulation_chain(n_tokens):
    """Every kernel runs on the tensor cores (the patch Grams and sym_gram,
    f32 and bf16) and never sums more than MAX_CHAIN_TOKENS tokens in one
    block's accumulator: the plan is the wave-filling count, raised to
    the chain cap where that binds."""
    for tiles, slots in ((15, 132), (15, 264), (45, 264), (2701, 396)):
        fill = launch.split_count(n_tokens, tiles, slots)
        capped = tpg.plan_splits(n_tokens, tiles, slots)
        assert capped == max(fill, -(-n_tokens // launch.MAX_CHAIN_TOKENS))
        assert -(-n_tokens // capped) <= launch.MAX_CHAIN_TOKENS


def test_chain_cap_binds_on_the_smoke_chain_case():
    """The shape chip_smoke.py checks at the cap, [132, 64, 64, 64] 3x3
    (N = 540,672, F = 576): 66 splits of exactly MAX_CHAIN_TOKENS tokens
    for either kernel's occupancy (1 or 2 blocks a card SM)."""
    for slots in (132, 264):
        splits = tpg.plan_splits(132 * 64 * 64, tpg.block_tiles(576, False),
                                 slots)
        assert splits == 66
        assert 132 * 64 * 64 == splits * launch.MAX_CHAIN_TOKENS


def _tf32_bits(t):
    return t.view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("relu", [False, True])
def test_tf32_split_halves_hold_x(relu):
    """``hi`` and ``lo`` are TF32 values (low 13 bits zero) and ``hi + lo``
    holds x to 2^-21 relative; ``hi`` is round-to-nearest, ties away."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        100_000).astype(np.float32))
    if relu:
        x = x.clamp_min(0)
    hi, lo = launch.tf32_split(x)
    assert int(_tf32_bits(hi).abs().max()) == 0
    assert int(_tf32_bits(lo).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # hi is the nearest TF32 value: within half its unit in the last place
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())
    # a tie (x halfway between two TF32 values) rounds away from zero
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert launch.tf32_split(tie)[0].tolist() == [1.0 + 2.0 ** -10,
                                               -(1.0 + 2.0 ** -10)]


def _patch_matrix(x, ks, pad):
    """[N, F+1] patch matrix of NHWC ``x``, (c, dy, dx) order, ones last."""
    p = torch.nn.functional.unfold(x.permute(0, 3, 1, 2), ks, padding=pad)
    p = p.transpose(1, 2).reshape(-1, p.shape[1])
    return torch.cat([p, p.new_ones(p.shape[0], 1)], dim=1)


@pytest.mark.parametrize("relu", [False, True])
def test_tf32x3_gram_is_within_1e_6_of_float64(relu):
    """The f32 kernel's arithmetic, emulated: the three TF32 products
    lo*hi + hi*lo + hi*hi summed in f32 (small terms first) are within
    1e-6 of max|G| of the float64 Gram of a [2, 28, 28, 64] 3x3 input, and
    agree with the JAX kernel (interpret mode) at its 1e-4 bar."""
    x = np.random.default_rng(4).standard_normal(
        (2, 28, 28, 64)).astype(np.float32)
    if relu:
        x = np.maximum(x, 0)
    p = _patch_matrix(torch.from_numpy(x), (3, 3), 1)
    hi, lo = launch.tf32_split(p)
    got = lo.T @ hi + hi.T @ lo + hi.T @ hi
    want = p.double().T @ p.double()
    assert float((got.double() - want).abs().max()) \
        <= 1e-6 * float(want.abs().max())
    jax_g = np.asarray(jpg.patch_gram_v2(jnp.asarray(x), (3, 3),
                                         ((1, 1), (1, 1)), (1, 1),
                                         interpret=True))
    _assert_gram_close(got.numpy(), jax_g)


def test_kernel_takes_f32_and_bf16_only():
    assert launch.check_kernel_dtype(torch.zeros(1), "k") == "f32"
    assert launch.check_kernel_dtype(torch.zeros(1).bfloat16(), "k") == "bf16"
    with pytest.raises(TypeError):
        launch.check_kernel_dtype(torch.zeros(1).half(), "k")


def test_tiled_rejects_infeasible_plan_like_jax():
    x = torch.zeros(1, 8, 8, 16)                     # C < 32
    with pytest.raises(ValueError):
        tpg.patch_gram_tiled(x, (3, 3), ((1, 1), (1, 1)))
    with pytest.raises(ValueError):
        jpg.patch_gram_tiled(jnp.zeros((1, 8, 8, 16)), (3, 3),
                             ((1, 1), (1, 1)), interpret=True)


def _resnet50_conv_shapes(batch=16, size=224):
    """(C, kernel, stride, H) of every ResNet-50 conv at ``size``."""
    shapes = [(3, 7, 2, size)]
    h = -(-size // 2) // 2                           # stem conv + maxpool
    c_in = 64
    for planes, n in zip((64, 128, 256, 512), (3, 4, 6, 3)):
        for i in range(n):
            s = 2 if (i == 0 and planes != 64) else 1
            shapes += [(c_in, 1, 1, h), (planes, 3, s, h),
                       (planes, 1, 1, -(-h // s))]
            if i == 0:
                shapes.append((c_in, 1, s, h))
            h, c_in = -(-h // s), planes * 4
    return [(c, (k, k), (s, s), hh, hh, batch) for c, k, s, hh in shapes]


@pytest.mark.parametrize("itemsize", [4, 2])
def test_dispatch_policy_matches_jax(itemsize):
    shapes = _resnet50_conv_shapes()
    assert len(shapes) == 53
    routes = []
    for c, ks, st, h, w, b in shapes:
        want = jpg.select_patch_gram(c, ks, st, h, w, b, itemsize)
        assert tpg.select_patch_gram(c, ks, st, h, w, b, itemsize) == want
        assert tpg.tiled_plan(c, ks, st, h, w, b, itemsize) \
            == jpg.tiled_plan(c, ks, st, h, w, b, itemsize)
        assert tpg.patch_gram_v2_supported(c, ks, st, h, w, itemsize) \
            == jpg.patch_gram_v2_supported(c, ks, st, h, w, itemsize)
        routes.append(want)
    if itemsize == 4:
        # layer1.{0,1,2}.conv2 -> tiled, layer2.0.conv2 -> v2 (the two
        # launches of the main path), and the stride-1 C=128 convs
        assert routes.count("tiled") == 3 + 3
        assert routes.count("v2") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry,shape,ks,pad,strides", [
    ("tiled", (16, 56, 56, 64), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ("tiled", (2, 9, 9, 96), (3, 3), "SAME", (1, 1)),
    ("tiled", (1, 10, 10, 32), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ("tiled", (2, 12, 12, 128), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ("v2", (16, 56, 56, 128), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ("v2", (32, 56, 56, 128), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ("v2", (3, 9, 9, 8), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ("v2", (2, 7, 9, 4), (3, 3), "SAME", (2, 2)),
    ("v2", (2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ("v2", (2, 7, 7, 6), (3, 3), ((1, 1), (1, 1)), (1, 1)),   # f32 scalar
    # the run-time-stride instance, and its main-path width
    *[("v2", *case) for case in RT_STRIDE_CASES],
    ("v2", (16, 56, 56, 128), (3, 3), ((1, 1), (1, 1)), (3, 3)),
    ("patch_gram", (16, 56, 56, 64), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    *[("patch_gram", *case, (1, 1)) for case in PG_CASES],
    *[("v2", *case) for case in BF16_EDGE_CASES],
])
def test_cuda_kernel_matches_plain(entry, shape, ks, pad, strides, dtype):
    """The CUDA kernel against its plain version on the card, at the
    main-path shapes and the odd cases, in f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).cuda().to(getattr(torch, dtype))
    fn = {"tiled": tpg.patch_gram_tiled, "v2": tpg.patch_gram_v2,
          "patch_gram": tpg.patch_gram}[entry]
    args = (x, ks, pad) if entry == "patch_gram" else (x, ks, pad, strides)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, fn(*args))                    # no atomics
    want = tpg.patch_gram_plain(x, ks, pad, strides)
    _assert_gram_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scalar_gather_on_a_misaligned_view(dtype):
    """A view one element into its storage (C = 64: the vector gather's
    channel count, but not 16-byte aligned) takes the scalar gather and
    computes the same Gram."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (2, 9, 9, 64)
    flat = torch.from_numpy(np.random.default_rng(0).standard_normal(
        int(np.prod(shape)) + 1).astype(np.float32)).cuda()
    x = flat.to(getattr(torch, dtype))[1:].view(shape)
    assert tpg.gather_kind(x) == "scalar"
    got = tpg.patch_gram_v2(x, (3, 3), ((1, 1), (1, 1)), (1, 1))
    want = tpg.patch_gram_plain(x, (3, 3), ((1, 1), (1, 1)))
    _assert_gram_close(got.cpu().numpy(), want.cpu().numpy())
