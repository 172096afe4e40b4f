"""The pure INF functions of the port against their JAX twins and against
dense numpy in float64: index selection (``dim_reduction``, ``_select``,
``_bucket``, ``_pad_indices``), the SIF diagonal, the R x R Gram, and the
Woodbury pieces (``pre_sampler``, ``inf_sample``, ``inf_solve``,
``inf_logdet``) on small random Kronecker bases."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from curvature_tpu.estimators import inf as jinf
from curvature_tpu_torch.estimators import inf as tinf

torch.set_num_threads(1)

#: (n, m, rank, max_product, bucket): A side n = cols, G side m = out
CASES = [(12, 7, 10, 0, 4), (12, 7, 10, 12, 4), (9, 9, 100, 0, 8),
         (16, 5, 6, 8, 1)]


def _orth(rng, d):
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return q.astype(np.float32)


def _problem(n, m, rank, max_product, bucket, seed=0, add=0.5, mul=3.0):
    """A layer's INF state as INF.update builds it (JAX's steps, in numpy),
    and the damped pieces: ua [n, L], ug [m, M], lam [L*M], corr
    [n*m], reg_lambda, inv_corr."""
    rng = np.random.default_rng(seed)
    ua_full, ug_full = _orth(rng, n), _orth(rng, m)
    # heavy-tailed lambdas, so the top set is not one product grid
    lam_vec = (rng.standard_normal(n * m) ** 4).astype(np.float32)
    left, right, _ = jinf.dim_reduction(lam_vec, n, m, rank, max_product)
    lb, rb = (jinf._bucket(len(left), n, bucket),
              jinf._bucket(len(right), m, bucket))
    left_p = jinf._pad_indices(left, lb, n)
    right_p = jinf._pad_indices(right, rb, m)
    mask = np.zeros((lb, rb), np.float32)
    mask[:len(left), :len(right)] = 1.0
    grid = (left_p[:, None] * m + right_p[None, :]).reshape(-1)
    ua, ug = ua_full[:, left_p], ug_full[:, right_p]
    lam = lam_vec[grid] * mask.reshape(-1)
    corr = np.abs(rng.standard_normal(n * m)).astype(np.float32)
    reg = np.sqrt(mul * lam).astype(np.float32)
    inv_corr = np.sqrt(1.0 / (mul * corr + add)).astype(np.float32)
    return dict(ua=ua, ug=ug, lam=lam, corr=corr, reg=reg,
                inv_corr=inv_corr, lam_vec=lam_vec)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _dense_precision(p):
    """D + V S^2 V^T in float64, flat layout k = i*m + j."""
    v = np.kron(p["ua"].astype(np.float64), p["ug"].astype(np.float64))
    d = 1.0 / p["inv_corr"].astype(np.float64) ** 2
    return np.diag(d) + (v * p["reg"].astype(np.float64) ** 2) @ v.T


@pytest.mark.parametrize("n,m,rank,max_product,bucket", CASES)
def test_index_selection_matches_jax(n, m, rank, max_product, bucket):
    lam = (np.random.default_rng(1).standard_normal(n * m) ** 4).astype(
        np.float32)
    for got, want in zip(tinf.dim_reduction(lam, n, m, rank, max_product),
                         jinf.dim_reduction(lam, n, m, rank, max_product)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tinf.INF._select(lam, n, m, rank, max_product),
                         jinf.INF._select(lam, n, m, rank, max_product)):
        np.testing.assert_array_equal(np.sort(got), np.sort(want))
    left, right, _ = tinf.dim_reduction(lam, n, m, rank, max_product)
    if max_product:
        assert len(left) * len(right) <= max_product
    assert tinf._bucket(len(left), n, bucket) \
        == jinf._bucket(len(left), n, bucket)
    size = tinf._bucket(len(left), n, bucket)
    np.testing.assert_array_equal(tinf._pad_indices(left, size, n),
                                  jinf._pad_indices(left, size, n))


@pytest.mark.parametrize("n,m,rank,max_product,bucket", CASES)
def test_sif_diagonal_matches_jax_and_dense(n, m, rank, max_product, bucket):
    p = _problem(n, m, rank, max_product, bucket)
    got = tinf.sif_diagonal(*_t(p["ua"], p["ug"], p["lam"])).numpy()
    want = np.asarray(jinf.sif_diagonal(jnp.asarray(p["ua"]),
                                        jnp.asarray(p["ug"]),
                                        jnp.asarray(p["lam"])))
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    v = np.kron(p["ua"].astype(np.float64), p["ug"].astype(np.float64))
    dense = np.einsum("kr,r,kr->k", v, p["lam"].astype(np.float64), v)
    np.testing.assert_allclose(got, dense, atol=1e-5 * np.abs(dense).max())


@pytest.mark.parametrize("n,m,rank,max_product,bucket", CASES)
def test_vtv_gram_matches_jax(n, m, rank, max_product, bucket):
    """The two Khatri-Rao products against JAX's einsum pair, 1e-5 of
    max."""
    p = _problem(n, m, rank, max_product, bucket)
    args = (p["ua"], p["ug"], p["reg"], p["inv_corr"])
    got = tinf._vtv_gram(*_t(*args)).numpy()
    want = np.asarray(jinf._vtv_gram(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,m,rank,max_product,bucket", CASES)
def test_pre_sampler_covariance_is_the_dense_inverse(n, m, rank,
                                                     max_product, bucket):
    """M M^T = inv(D + V S^2 V^T) for the sampler M (its columns are
    ``inf_sample`` of the unit draws), against float64 numpy at 1e-4 of
    max; ``pre`` against JAX's at 1e-4 of max."""
    p = _problem(n, m, rank, max_product, bucket)
    ua, ug, reg, ic = _t(p["ua"], p["ug"], p["reg"], p["inv_corr"])
    pre = tinf.pre_sampler(ua, ug, reg, ic)
    want_pre = np.asarray(jinf.pre_sampler(*map(jnp.asarray, (
        p["ua"], p["ug"], p["reg"], p["inv_corr"]))))
    np.testing.assert_allclose(pre.numpy(), want_pre,
                               atol=1e-4 * np.abs(want_pre).max())
    eye = torch.eye(n * m)
    cols = tinf.inf_sample(ua, ug, ic, pre, eye)       # [n*m, m, n]
    mat = cols.transpose(-1, -2).reshape(n * m, n * m).T.double().numpy()
    cov = mat @ mat.T
    want = np.linalg.inv(_dense_precision(p))
    np.testing.assert_allclose(cov, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n,m,rank,max_product,bucket", CASES)
def test_inf_solve_and_logdet_match_dense(n, m, rank, max_product, bucket):
    """``inf_solve`` against ``np.linalg.solve`` and ``inf_logdet`` against
    ``slogdet`` of the float64 precision; both against JAX."""
    p = _problem(n, m, rank, max_product, bucket)
    rng = np.random.default_rng(3)
    mat = rng.standard_normal((m, n)).astype(np.float32)      # [out, cols]
    ua, ug, reg, ic, tmat = _t(p["ua"], p["ug"], p["reg"], p["inv_corr"],
                               mat)
    pre = tinf.pre_sampler(ua, ug, reg, ic)
    got = tinf.inf_solve(ua, ug, ic, pre, tmat).numpy()
    dense = _dense_precision(p)
    want = np.linalg.solve(dense, mat.T.reshape(-1).astype(np.float64))
    want = want.reshape(n, m).T
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    jargs = [jnp.asarray(a) for a in (p["ua"], p["ug"], p["reg"],
                                       p["inv_corr"])]
    jpre = jinf.pre_sampler(*jargs)
    jsol = np.asarray(jinf.inf_solve(jargs[0], jargs[1], jargs[3], jpre,
                                     jnp.asarray(mat)))
    np.testing.assert_allclose(got, jsol, atol=1e-4 * np.abs(jsol).max())
    logdet = float(tinf.inf_logdet(ua, ug, reg, ic))
    sign, want_ld = np.linalg.slogdet(dense)
    assert sign > 0 and abs(logdet - want_ld) <= 1e-5 * abs(want_ld)
    jld = float(jinf.inf_logdet(*jargs))
    assert abs(logdet - jld) <= 1e-5 * abs(jld)


def test_safe_reg_lambda_is_zero_at_zero():
    lam = torch.tensor([0.0, 4.0, 0.0, 1.0])
    np.testing.assert_array_equal(tinf._safe_reg_lambda(9.0, lam).numpy(),
                                  [0.0, 6.0, 0.0, 3.0])
