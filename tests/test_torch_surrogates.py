"""The damping search's surrogate models (``pipelines/surrogates.py``)
against the scikit-learn regressors the JAX ``pipelines/hyper.py`` builds.

The Gaussian process follows scikit-learn's arithmetic, so its fitted
length scale and its predictions agree to 1e-6; gradient boosting agrees
on the training points (where ties between features that split the
points alike leave the partition, and so the predictions, the same);
extra trees draw from numpy's streams, so they are held to their
contract. Inputs are numpy-seeded points of the search space with an
objective-like target.
"""
import warnings

import numpy as np
import pytest

from curvature_tpu_torch.pipelines import surrogates

sklearn = pytest.importorskip("sklearn")
from sklearn.ensemble import GradientBoostingRegressor  # noqa: E402
from sklearn.gaussian_process import GaussianProcessRegressor  # noqa: E402
from sklearn.gaussian_process.kernels import Matern  # noqa: E402


def _points(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10.0, 10.0, (n, 2))
    y = 50.0 * np.sin(x[:, 0] / 3.0) + x[:, 1] ** 2 + rng.normal(size=n)
    return x, y, rng.uniform(-10.0, 10.0, (512, 2))


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (5, 2), (12, 3),
                                    (30, 4)])
def test_gaussian_process_matches_sklearn(n, seed):
    """Length scale, mean and standard deviation on 512 candidates, and
    the log marginal likelihood: 1e-6 relative to the max."""
    x, y, cand = _points(n, seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = GaussianProcessRegressor(
            kernel=Matern(nu=2.5, length_scale=2.0), normalize_y=True,
            alpha=1e-6).fit(x, y)
        w_mu, w_sd = want.predict(cand, return_std=True)
    got = surrogates.GaussianProcess().fit(x, y)
    g_mu, g_sd = got.predict(cand, return_std=True)
    assert got.length_scale_ == pytest.approx(want.kernel_.length_scale,
                                              rel=1e-6)
    assert got.log_marginal_likelihood_value_ == pytest.approx(
        want.log_marginal_likelihood_value_, rel=1e-6, abs=1e-9)
    np.testing.assert_allclose(g_mu, w_mu, atol=1e-6 * np.abs(w_mu).max())
    np.testing.assert_allclose(g_sd, w_sd,
                               atol=1e-6 * max(np.abs(w_sd).max(), 1e-12))
    np.testing.assert_allclose(got.predict(cand), w_mu,
                               atol=1e-6 * np.abs(w_mu).max())


@pytest.mark.parametrize("n,seed", [(2, 0), (6, 1), (12, 2), (40, 3)])
def test_gradient_boosting_matches_sklearn_on_training_points(n, seed):
    """100 stages of depth-3 trees at learning rate 0.1 from the mean: the
    training-point predictions 1e-9 relative to the max; off the points
    the prediction is finite and as deterministic per seed."""
    x, y, cand = _points(n, seed)
    want = GradientBoostingRegressor(random_state=seed).fit(x, y)
    got = surrogates.GradientBoosting(random_state=seed).fit(x, y)
    np.testing.assert_allclose(got.predict(x), want.predict(x),
                               atol=1e-9 * np.abs(y).max())
    assert len(got.estimators_) == 100
    again = surrogates.GradientBoosting(random_state=seed).fit(x, y)
    np.testing.assert_array_equal(again.predict(cand), got.predict(cand))
    assert np.isfinite(got.predict(cand)).all()


@pytest.mark.parametrize("n,seed", [(1, 0), (3, 1), (10, 2), (40, 3)])
def test_extra_trees_contract(n, seed):
    """50 trees grown to one sample per leaf: every tree predicts each
    training point's target exactly (so the per-tree spread there is 0
    and the forest interpolates); a duplicated input gets its targets'
    mean; off the points the per-tree spread is positive somewhere and
    the predictions lie within the targets' range; the same seed builds
    the same forest, another seed another one."""
    x, y, cand = _points(n, seed)
    model = surrogates.ExtraTrees(n_estimators=50, random_state=seed)
    model.fit(x, y)
    assert len(model.estimators_) == 50
    per_tree = np.stack([t.predict(x) for t in model.estimators_])
    assert np.array_equal(per_tree, np.broadcast_to(y, per_tree.shape))
    assert per_tree.std(0).max() <= 1e-12 * max(np.abs(y).max(), 1.0)
    np.testing.assert_allclose(model.predict(x), y,
                               atol=1e-12 * np.abs(y).max())
    off = np.stack([t.predict(cand) for t in model.estimators_])
    assert off.min() >= y.min() and off.max() <= y.max()
    if n > 1:
        assert off.std(0).max() > 0
    same = surrogates.ExtraTrees(50, random_state=seed).fit(x, y)
    np.testing.assert_array_equal(same.predict(cand), model.predict(cand))
    if n > 2:
        other = surrogates.ExtraTrees(50, random_state=seed + 100).fit(x, y)
        assert not np.array_equal(other.predict(cand), model.predict(cand))
    # duplicated inputs with different targets: one leaf, their mean
    xd = np.concatenate([x, x[:1]])
    yd = np.concatenate([y, y[:1] + 2.0])
    dup = surrogates.ExtraTrees(5, random_state=seed).fit(xd, yd)
    np.testing.assert_allclose(dup.predict(x[:1]), y[:1] + 1.0, rtol=1e-12)


def test_matern_gradient_is_the_log_length_scale_derivative():
    """The kernel's analytic gradient against central differences in log
    length scale: 1e-7 of max."""
    x, _, _ = _points(7, 5)
    ell, h = 1.7, 1e-6
    _, grad = surrogates.matern52(x, None, ell, eval_gradient=True)
    fd = (surrogates.matern52(x, None, ell * np.exp(h))
          - surrogates.matern52(x, None, ell * np.exp(-h))) / (2 * h)
    np.testing.assert_allclose(grad[..., 0], fd,
                               atol=1e-7 * np.abs(fd).max())
