"""Port parity: ``sym_gram`` of ``curvature_tpu_torch`` against the JAX
Pallas ``sym_gram`` (interpret mode), in f32 and bf16, both variants, and
its shape gate against the JAX one; the f32 kernel's arithmetic (3xTF32
from pre-split operands), the pre-pass's slab layout, and the split plan.

On the CPU the port computes its plain version (and, below the gate, the
plain product, as the JAX function's einsum); the CUDA kernels are held
against their plain versions by the ``cuda``-marked test, which skips
where there is no card.
"""
import importlib

import numpy as np
import pytest
import torch

from curvature_tpu_torch.ops.cuda import launch
from curvature_tpu_torch.ops.cuda import sym_gram as tsg

try:
    import jax.numpy as jnp
    jsg = importlib.import_module("curvature_tpu.ops.pallas.sym_gram")
except ImportError:
    # the card's machine has no JAX: only the cuda-marked tests run there
    # (python -m pytest tests/test_torch_sym_gram.py --noconftest -m cuda)
    jnp = jsg = None

torch.set_num_threads(1)

#: a CPU-sized subset of tests/test_pallas_kernels.py:129-130: (700, 577)
#: passes the gate and pads both N and F in the TPU plan; (100, 64) is
#: below the gate (one einsum); (200, 520) passes it with F % 8 == 0 (the
#: bf16 kernel reads its rows unpadded)
CASES = [(700, 577), (100, 64), (200, 520)]


def _inputs(shape, dtype):
    """Numpy normals (rounded to bf16 for bf16), the same values for both
    packages."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


def _assert_close(got, want):
    """The JAX test's bar (tests/test_pallas_kernels.py:140): 2e-5 of
    max(max|want|, 1); f32 sums of exact products in both."""
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want,
                               atol=2e-5 * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("variant", ["tri", "rect"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f", CASES)
def test_sym_gram_matches_jax(n, f, dtype, variant):
    x, jx = _inputs((n, f), dtype)
    want = np.asarray(jsg.sym_gram(jx, interpret=True, variant=variant))
    got = tsg.sym_gram(x, variant=variant)
    _assert_close(got.numpy(), want)
    if tsg.sym_gram_supported(n, f):
        # the upper triangle is the lower one's values: bitwise symmetric
        assert torch.equal(got, got.T)
        assert torch.equal(got, tsg.sym_gram(x, variant="rect"))


@pytest.mark.parametrize("n,f", [(784, 4609), (3136, 1025), (700, 577),
                                 (513, 2049), (100, 64), (10, 512),
                                 (10, 513), (10, 256), (10, 257)])
def test_sym_gram_supported_gate_matches_jax(n, f):
    assert tsg.sym_gram_supported(n, f) == jsg.sym_gram_supported(n, f)


@pytest.mark.parametrize("n,f", [(700, 577), (100, 13), (64, 600)])
def test_padded_features_leave_the_gram_unchanged(n, f):
    """The bf16 kernel runs on rows padded to 8 features; the plain Gram of
    the padded input, cut to [F, F], is that of the input bit for bit."""
    x = _inputs((n, f), "bfloat16")[0]
    xp = tsg.pad_features(x)
    assert xp.shape == (n, f + (-f % 8)) and xp.data_ptr() % 16 == 0
    assert torch.equal(xp[:, :f], x) and not xp[:, f:].any()
    assert torch.equal(tsg.sym_gram_plain(xp)[:f, :f], tsg.sym_gram_plain(x))
    if f % 8 == 0:
        assert tsg.pad_features(x) is x


def test_sym_gram_rejects_unknown_variant():
    with pytest.raises(ValueError):
        tsg.sym_gram(torch.zeros(4, 600), variant="full")


def test_cpu_sym_gram_counts_no_launch():
    before = tsg.sym_gram.launches
    tsg.sym_gram(torch.zeros(8, 600))
    tsg.sym_gram(torch.zeros(8, 64))
    assert tsg.sym_gram.launches == before


def test_cpu_presplit_is_its_plain_version_and_counts_no_launch():
    x = _inputs((40, 70), "float32")[0]
    before = tsg.tf32_presplit.launches
    assert torch.equal(tsg.tf32_presplit(x), tsg.tf32_presplit_plain(x))
    assert tsg.tf32_presplit.launches == before
    with pytest.raises(TypeError):
        tsg.tf32_presplit(x.bfloat16())


def _unswizzle(op):
    """[2, chunks, blocks, 64, 8, 4] slabs -> [2, features, tokens]: quad
    j of feature row r of a slab is read from position j ^ (r % 8)."""
    a = op.numpy()
    two, nc, fb = a.shape[:3]
    out = np.full((2, fb, 64, nc, 8, 4), np.nan, np.float32)
    for r in range(64):
        for j in range(8):
            out[:, :, r, :, j, :] = a[:, :, :, r, j ^ (r % 8), :].transpose(
                0, 2, 1, 3)
    return out.reshape(2, fb * 64, nc * 32)


@pytest.mark.parametrize("n,f", [(700, 577), (200, 520), (100, 13)])
def test_presplit_plain_layout(n, f):
    """Un-swizzled, the pre-pass's slabs are ``tf32_split(x)`` transposed
    (features as rows, tokens contiguous) and zero-padded to whole
    CHUNK-token chunks and F32_TILE-feature tiles, bit for bit."""
    x = _inputs((n, f), "float32")[0]
    op = tsg.tf32_presplit_plain(x)
    fp = -(-f // tsg.F32_TILE) * tsg.F32_TILE
    np_ = -(-n // tsg.CHUNK) * tsg.CHUNK
    assert op.shape == tsg.presplit_shape(n, f) \
        == (2, np_ // 32, fp // 64, 64, 8, 4)
    got = _unswizzle(op)
    for half, want in zip(got, launch.tf32_split(x)):
        padded = np.zeros((fp, np_), np.float32)
        padded[:f, :n] = want.numpy().T
        assert np.array_equal(half.view(np.int32), padded.view(np.int32))


@pytest.mark.parametrize("n,f", CASES)
def test_tf32x3_sym_gram_matches_jax(n, f):
    """The f32 kernel's arithmetic, emulated: lo*hi + hi*lo + hi*hi of the
    TF32 halves summed in f32, against the JAX Pallas ``sym_gram``
    (interpret mode) at its bar, 2e-5 of max(max|G|, 1)."""
    x, jx = _inputs((n, f), "float32")
    hi, lo = launch.tf32_split(x)
    got = lo.T @ hi + hi.T @ lo + hi.T @ hi
    want = np.asarray(jsg.sym_gram(jx, interpret=True))
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("n,f,slots,want", [
    (784, 4609, 132, (1, 800)),        # 703 block tiles: 5.3 waves, 1 pass
    (784, 2305, 132, (1, 800)),        # 190 block tiles: 1.4 waves
    (513, 2049, 132, (1, 544)),        # 153 block tiles (561 64-tiles)
    (16384, 4609, 132, (2, 8192)),     # the chain cap alone: 2 splits
    (16384, 4609, 264, (2, 8192)),
    (3136, 1025, 132, (5, 640)),       # 45 block tiles: 0.34 waves
    (3136, 1025, 44, (1, 3136)),       # 45 block tiles fill 44 slots
    (700, 577, 264, (1, 704)),         # wave-filling: 1 split of 15 tiles
    (40_000, 577, 132, (17, 2368)),
])
def test_f32_split_plan_caps_chains_and_counts_block_tiles(n, f, slots,
                                                             want):
    """f32 splits: whole CHUNK-token chunks, no block past
    MAX_CHAIN_TOKENS, no empty split, and the count from the kernel's
    F32_TILE-feature block tiles (one pass when they fill ONE_PASS_WAVES
    waves, else the wave-filling plan)."""
    splits, per = tsg.split_plan(n, f, False, slots)
    assert (splits, per) == want
    assert per % tsg.CHUNK == 0 and per <= launch.MAX_CHAIN_TOKENS
    assert (splits - 1) * per < n <= splits * per


@pytest.mark.parametrize("n,f,slots,want", [
    (784, 4609, 396, (1, 784)),
    (16384, 4609, 396, (8, 2048)),     # the bf16 chain cap alone
    (2048, 4609, 396, (1, 2048)), (2049, 4609, 396, (2, 1025)),
    (3136, 1025, 396, (5, 628)), (600, 1024, 264, (1, 600)),
    (40_000, 577, 396, (20, 2000)),    # the cap over 7 wave-filling splits
])
def test_bf16_split_plan_counts_64_tiles(n, f, slots, want):
    """bf16 splits: any token count, the wave-filling count of 64-feature
    block tiles (the bf16 kernel's edge), raised so that no block sums
    more than BF16_CHAIN_TOKENS in its unflushed accumulator."""
    splits, per = tsg.split_plan(n, f, True, slots)
    assert (splits, per) == want
    assert per <= tsg.BF16_CHAIN_TOKENS and (splits - 1) * per < n


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,dtype", [
    (n, f, dtype) for n, f in [(784, 4609), (3136, 1025), (700, 577),
                               (513, 2049), (600, 1024),
                               # the chain cap: every block sums a full
                               # chain (f32 2 x 8,192 tokens, bf16 8 x 2,048)
                               (16384, 4609)]
    for dtype in ("float32", "bfloat16")])
def test_cuda_kernel_matches_plain(n, f, dtype):
    """The CUDA kernels against their plain versions on the card: the f32
    pre-pass bit for bit, the Gram within the JAX bar, bitwise symmetric,
    the same bits from both variants and from a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, f)).astype(np.float32)).cuda().to(getattr(torch, dtype))
    if n == 16384:
        bf16 = dtype == "bfloat16"
        cap = tsg.BF16_CHAIN_TOKENS if bf16 else launch.MAX_CHAIN_TOKENS
        slots = tsg._resident_blocks(x.device.index, bf16)
        assert tsg.split_plan(n, f, bf16, slots) == (n // cap, cap)
    if dtype == "float32":
        assert torch.equal(tsg.tf32_presplit(x), tsg.tf32_presplit_plain(x))
    before = tsg.sym_gram.launches
    got = tsg.sym_gram(x)
    torch.cuda.synchronize()
    assert tsg.sym_gram.launches == before + 1
    assert torch.equal(got, tsg.sym_gram(x))
    assert torch.equal(got, got.T)
    assert torch.equal(got, tsg.sym_gram(x, variant="rect"))
    _assert_close(got.cpu().numpy(), tsg.sym_gram_plain(x).cpu().numpy())
