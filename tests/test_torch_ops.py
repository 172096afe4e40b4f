"""Port parity of ``curvature_tpu_torch.ops`` against ``curvature_tpu.ops``:
padding resolution, patch extraction, the damped-inversion linear algebra,
and the correlation patch-Gram (groups=1)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from curvature_tpu.ops import corr_gram as jcorr
from curvature_tpu.ops import linalg as jlin
from curvature_tpu.ops import patches as jpatches
from curvature_tpu_torch.ops import corr_gram as tcorr
from curvature_tpu_torch.ops import linalg as tlin
from curvature_tpu_torch.ops import patches as tpatches

torch.set_num_threads(1)


@pytest.mark.parametrize("h,w,ks,strides", [
    (7, 9, (3, 3), (2, 2)),        # odd dims, stride 2: asymmetric SAME
    (8, 8, (3, 3), (2, 2)),
    (9, 7, (3, 3), (1, 1)),
    (224, 224, (7, 7), (2, 2)),
    (10, 11, (2, 2), (1, 1)),      # even kernel: the high side gets more
    (5, 6, (5, 5), (3, 3)),
])
def test_resolve_padding_same_matches_jax(h, w, ks, strides):
    want = jpatches.resolve_padding("SAME", h, w, ks, strides)
    assert tpatches.resolve_padding("SAME", h, w, ks, strides) == want


def test_resolve_padding_valid_and_explicit():
    assert tpatches.resolve_padding("VALID", 5, 5, (3, 3)) == ((0, 0), (0, 0))
    pad = ((0, 2), (2, 0))
    assert tpatches.resolve_padding(pad, 5, 5, (3, 3)) \
        == jpatches.resolve_padding(pad, 5, 5, (3, 3))


@pytest.mark.parametrize("shape,ks,strides,pad", [
    ((2, 8, 8, 3), (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((2, 7, 9, 4), (3, 3), (2, 2), "SAME"),
    ((1, 10, 10, 2), (5, 5), (1, 1), ((2, 2), (2, 2))),
    ((2, 9, 9, 3), (7, 7), (2, 2), ((3, 3), (3, 3))),
    ((2, 8, 8, 3), (3, 3), (1, 1), "VALID"),
    ((1, 12, 12, 5), (3, 3), (1, 1), ((0, 2), (2, 0))),
])
def test_extract_patches_matches_jax(shape, ks, strides, pad):
    """Exact copies of the input (no arithmetic): atol 1e-6."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jpatches.extract_patches(jnp.asarray(x), ks, strides,
                                               pad))
    got = tpatches.extract_patches(torch.from_numpy(x), ks, strides,
                                   pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def _spd_stack(seed, n=3, d=7):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, d, d)).astype(np.float32)
    return (m @ m.transpose(0, 2, 1) / d
            + 0.5 * np.eye(d, dtype=np.float32)).astype(np.float32)


def _close_rel(got, want, rtol):
    """Relative to the largest entry: f32 factorizations in another
    order."""
    np.testing.assert_allclose(got, want,
                               atol=rtol * max(np.abs(want).max(), 1.0))


def test_sym_matches_jax():
    a = np.random.default_rng(1).standard_normal((2, 5, 5)).astype(
        np.float32)
    _close_rel(tlin.sym(torch.from_numpy(a)).numpy(),
               np.asarray(jlin.sym(jnp.asarray(a))), 1e-7)


def test_chol_inv_matches_jax():
    a = _spd_stack(2)
    _close_rel(tlin.chol_inv(torch.from_numpy(a)).numpy(),
               np.asarray(jlin.chol_inv(jnp.asarray(a))), 1e-5)


def test_chol_logdet_matches_jax():
    a = _spd_stack(3)
    _close_rel(tlin.chol_logdet(torch.from_numpy(a)).numpy(),
               np.asarray(jlin.chol_logdet(jnp.asarray(a))), 1e-5)


@pytest.mark.parametrize("add,multiply", [(1.0, 1.0), (0.1, 100.0),
                                          (1.0, 18916.0)])
def test_damped_inverse_cholesky_matches_jax(add, multiply):
    a = _spd_stack(4)
    want = np.asarray(jlin.damped_inverse_cholesky(jnp.asarray(a), add,
                                                   multiply))
    got = tlin.damped_inverse_cholesky(torch.from_numpy(a), add,
                                       multiply).numpy()
    _close_rel(got, want, 1e-5)


#: tests/test_corr_gram.py:29-43
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
]


@pytest.mark.parametrize("shape,ks,pad,bias", CORR_CASES)
def test_corr_patch_gram_matches_jax(shape, ks, pad, bias):
    """1e-5 of max|G|: the same shifted-slice sums in another order."""
    x = np.random.default_rng(0).standard_normal((4,) + shape).astype(
        np.float32)
    want = np.asarray(jcorr.corr_patch_gram(jnp.asarray(x), ks, pad,
                                            has_bias=bias))
    got = tcorr.corr_patch_gram(torch.from_numpy(x), ks, pad,
                                has_bias=bias).numpy()
    assert got.shape == want.shape
    _close_rel(got, want, 1e-5)


def test_corr_gram_supported_gate():
    for ks, st in [((3, 3), (1, 1)), ((3, 3), (2, 2)), ((1, 1), (1, 1)),
                   ((1, 3), (1, 1))]:
        assert tcorr.corr_gram_supported(ks, st) \
            == jcorr.corr_gram_supported(ks, st)
