"""Port parity: ``sym_gram`` of ``curvature_tpu_torch`` against the JAX
Pallas ``sym_gram`` (interpret mode), in f32 and bf16, both variants, and
its shape gate against the JAX one.

On the CPU the port computes its plain version (and, below the gate, the
plain product, as the JAX function's einsum); the CUDA kernel is held
against the plain version by the ``cuda``-marked test, which skips where
there is no card.
"""
import importlib

import numpy as np
import pytest
import torch

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f", [(784, 4609), (3136, 1025), (700, 577),
                                 (513, 2049), (600, 1024)])
def test_cuda_kernel_matches_plain(n, f, dtype):
    """The CUDA kernel against its plain version on the card: within the
    JAX bar, bitwise symmetric, the same bits from both variants and from
    a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, f)).astype(np.float32)).cuda().to(getattr(torch, dtype))
    before = tsg.sym_gram.launches
    got = tsg.sym_gram(x)
    torch.cuda.synchronize()
    assert tsg.sym_gram.launches == before + 1
    assert torch.equal(got, got.T)
    assert torch.equal(got, tsg.sym_gram(x, variant="rect"))
    _assert_close(got.cpu().numpy(), tsg.sym_gram_plain(x).cpu().numpy())
