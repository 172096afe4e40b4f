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


@pytest.mark.parametrize("shape,ks,pad", [
    ((8, 8, 3), (3, 3), ((1, 1), (1, 1))),      # tests/test_corr_gram.py:53
    ((9, 7, 4), (3, 3), "SAME"),
])
def test_corr_patch_gram_bf16_operands_match_jax(shape, ks, pad):
    """bf16 operands, f32 output: exact products and f32 sums in both
    packages, so 1e-5 of max|G| (the JAX test holds its bf16 result to
    2e-2 of the f32 one; here both sides see the same bf16 values)."""
    x = np.random.default_rng(1).standard_normal((4,) + shape).astype(
        np.float32)
    xt = torch.from_numpy(x).bfloat16()
    jx = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jcorr.corr_patch_gram(jx, ks, pad))
    got = tcorr.corr_patch_gram(xt, ks, pad)
    assert got.dtype == torch.float32
    _close_rel(got.numpy(), want, 1e-5)


def test_corr_gram_supported_gate():
    for ks, st in [((3, 3), (1, 1)), ((3, 3), (2, 2)), ((1, 1), (1, 1)),
                   ((1, 3), (1, 1))]:
        assert tcorr.corr_gram_supported(ks, st) \
            == jcorr.corr_gram_supported(ks, st)


def test_kron_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 5)).astype(np.float32)
    got = tlin.kron(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlin.kron(jnp.asarray(a),
                                                            jnp.asarray(b))))
    np.testing.assert_allclose(got, np.kron(a, b), atol=1e-6)


@pytest.mark.parametrize("value", [0.0, 0.5, -2.0])
def test_diag_add_matches_jax(value):
    a = _spd_stack(6)
    got = tlin.diag_add(torch.from_numpy(a), value).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlin.diag_add(
        jnp.asarray(a), value)))


def test_eigh_sym_matches_jax():
    """Eigenvalues of A + A^T (a sum: twice A's) at 1e-5 of max; on a
    separated spectrum the eigenvectors agree up to sign, |U_jax^T U| = I
    at 1e-4."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((3, 8, 8)))
    evals = np.linspace(1.0, 8.0, 8)
    a = (q * evals[None, None, :]) @ q.transpose(0, 2, 1)
    a = a.astype(np.float32)
    w_t, u_t = tlin.eigh_sym(torch.from_numpy(a))
    w_j, u_j = jlin.eigh_sym(jnp.asarray(a))
    _close_rel(w_t.numpy(), np.asarray(w_j), 1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.broadcast_to(2 * evals,
                                                            (3, 8)),
                               atol=1e-4)
    overlap = np.abs(np.asarray(u_j).transpose(0, 2, 1) @ u_t.numpy())
    np.testing.assert_allclose(overlap, np.broadcast_to(np.eye(8), (3, 8, 8)),
                               atol=1e-4)


def test_group_by_shape_and_ungroup_match_jax():
    rng = np.random.default_rng(8)
    arrays = {n: rng.standard_normal(s).astype(np.float32) for n, s in
              [("a", (3, 3)), ("b", (4, 4)), ("c", (3, 3)), ("d", (4,)),
               ("e", (4, 4))]}
    got = tlin.group_by_shape({k: torch.from_numpy(v)
                               for k, v in arrays.items()})
    want = jlin.group_by_shape({k: jnp.asarray(v) for k, v in arrays.items()})
    assert [names for names, _ in got] == [names for names, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = tlin.ungroup(got)
    assert list(back) == ["a", "c", "b", "e", "d"]
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
