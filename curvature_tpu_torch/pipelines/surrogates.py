"""Surrogate models of the damping search, in numpy and scipy.

The JAX ``pipelines/hyper.py`` builds three scikit-learn regressors for its
sequential model-based optimizers (:334-345). This module holds
equivalents of exactly those three, so that the port's ``hyper`` needs
no scikit-learn:

* :class:`GaussianProcess`: ``GaussianProcessRegressor(Matern(nu=2.5,
  length_scale=2.0), normalize_y=True, alpha=1e-6)`` with scikit-learn's
  defaults: y standardized by its mean and standard deviation, one
  L-BFGS-B fit of the log length scale on the log marginal likelihood
  (analytic gradient, bounds 1e-5..1e5, no restarts), ``return_std``
  with negative variances clipped to 0. The arithmetic follows
  scikit-learn's step by step, so both give the same numbers.
* :class:`ExtraTrees`: ``ExtraTreesRegressor(n_estimators=50,
  random_state=seed)``: no bootstrap, every feature tried at every node,
  one uniform random threshold per feature, the best of them by variance
  reduction, nodes split down to one sample or a constant target. Its
  random streams are numpy's, not scikit-learn's: the same contract,
  other trees. ``estimators_`` holds the trees (JAX reads each tree's
  prediction).
* :class:`GradientBoosting`: ``GradientBoostingRegressor(random_state=
  seed)``: squared error, the mean as the initial prediction, 100 stages
  of depth-3 trees at learning rate 0.1, exhaustive best splits at the
  midpoints between sorted distinct values (``friedman_mse`` ranks the
  splits of a node as the MSE reduction does).

The trees split on float32 copies of the inputs, as scikit-learn's do.
"""
import math
from typing import List, Optional

import numpy as np
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.optimize import minimize
from scipy.spatial.distance import cdist, pdist, squareform

#: two feature values closer than this are one value (scikit-learn's
#: ``FEATURE_THRESHOLD``)
FEATURE_THRESHOLD = 1e-7
EPSILON = np.finfo(np.float64).eps


# -- Gaussian process -------------------------------------------------------

def matern52(x: np.ndarray, y: Optional[np.ndarray], length_scale: float,
             eval_gradient: bool = False):
    """Matern nu=2.5 kernel k(x, y) (k(x, x) when ``y`` is None) and,
    with ``eval_gradient``, its [n, n, 1] gradient with respect to the
    log length scale."""
    if y is None:
        dists = pdist(x / length_scale, metric="euclidean")
    else:
        dists = cdist(x / length_scale, y / length_scale,
                      metric="euclidean")
    k = dists * math.sqrt(5)
    k = (1.0 + k + k ** 2 / 3.0) * np.exp(-k)
    if y is None:
        k = squareform(k)
        np.fill_diagonal(k, 1)
    if not eval_gradient:
        return k
    d = squareform(dists ** 2)[:, :, np.newaxis]
    tmp = np.sqrt(5 * d.sum(-1))[..., np.newaxis]
    grad = 5.0 / 3.0 * d * (tmp + 1) * np.exp(-tmp)
    return k, grad[:, :].sum(-1)[:, :, np.newaxis]


class GaussianProcess:
    """GP regression with a Matern-5/2 kernel (see the module doc)."""

    def __init__(self, length_scale: float = 2.0, alpha: float = 1e-6,
                 bounds=(1e-5, 1e5)):
        self.length_scale = float(length_scale)
        self.alpha = alpha
        self.bounds = np.log(np.asarray([bounds], np.float64))

    def _lml(self, theta: np.ndarray):
        """(log marginal likelihood, its gradient) at log length scale
        ``theta`` on the standardized targets."""
        k, k_grad = matern52(self.x_train_, None, np.exp(theta[0]), True)
        k[np.diag_indices_from(k)] += self.alpha
        try:
            low = cholesky(k, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return -np.inf, np.zeros_like(theta)
        y = self.y_train_[:, np.newaxis]
        alpha = cho_solve((low, True), y, check_finite=False)
        lml = -0.5 * np.einsum("ik,ik->k", y, alpha)
        lml -= np.log(np.diag(low)).sum()
        lml -= k.shape[0] / 2 * np.log(2 * np.pi)
        inner = np.einsum("ik,jk->ijk", alpha, alpha)
        k_inv = cho_solve((low, True), np.eye(k.shape[0]),
                          check_finite=False)
        inner -= k_inv[..., np.newaxis]
        grad = 0.5 * np.einsum("ijl,jik->kl", inner, k_grad)
        return lml.sum(axis=-1), grad.sum(axis=-1)

    def fit(self, x, y) -> "GaussianProcess":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        self.y_mean_ = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self.y_std_ = 1.0 if std == 0.0 else std
        self.x_train_ = np.copy(x)
        self.y_train_ = (y - self.y_mean_) / self.y_std_

        def neg(theta):
            lml, grad = self._lml(theta)
            return -lml, -grad
        res = minimize(neg, np.log(np.hstack([self.length_scale])),
                       method="L-BFGS-B", jac=True, bounds=self.bounds)
        self.length_scale_ = float(np.exp(res.x[0]))
        self.log_marginal_likelihood_value_ = -float(res.fun)
        k = matern52(self.x_train_, None, self.length_scale_)
        k[np.diag_indices_from(k)] += self.alpha
        self.low_ = cholesky(k, lower=True, check_finite=False)
        self.alpha_ = cho_solve((self.low_, True), self.y_train_,
                                check_finite=False)
        return self

    def predict(self, x, return_std: bool = False):
        x = np.asarray(x, np.float64)
        k_trans = matern52(x, self.x_train_, self.length_scale_)
        mean = self.y_std_ * (k_trans @ self.alpha_) + self.y_mean_
        if not return_std:
            return mean
        v = solve_triangular(self.low_, k_trans.T, lower=True,
                             check_finite=False)
        var = np.ones(x.shape[0])
        var -= np.einsum("ij,ji->i", v.T, v)
        var[var < 0] = 0.0
        var = np.outer(var, self.y_std_ ** 2).reshape(*var.shape, -1)
        return mean, np.sqrt(np.squeeze(var, axis=1))


# -- regression trees --------------------------------------------------------

class Tree:
    """A fitted binary regression tree: node arrays ``feature``,
    ``threshold``, ``left``, ``right`` (-1 at leaves) and ``value`` (the
    node's mean target). A sample goes left where its feature value is at
    most the threshold."""

    def __init__(self):
        self.feature: List[int] = []
        self.threshold: List[float] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.value: List[float] = []

    def add(self, value: float) -> int:
        for arr, v in ((self.feature, -1), (self.threshold, 0.0),
                       (self.left, -1), (self.right, -1),
                       (self.value, value)):
            arr.append(v)
        return len(self.value) - 1

    def apply(self, x: np.ndarray) -> np.ndarray:
        """The leaf index of every row of ``x`` (float32)."""
        x = np.asarray(x, np.float32)
        node = np.zeros(x.shape[0], np.int64)
        feature, threshold = np.asarray(self.feature), np.asarray(
            self.threshold)
        left, right = np.asarray(self.left), np.asarray(self.right)
        active = left[node] >= 0
        while active.any():
            i = np.nonzero(active)[0]
            go_left = x[i, feature[node[i]]] <= threshold[node[i]]
            node[i] = np.where(go_left, left[node[i]], right[node[i]])
            active = left[node] >= 0
        return node

    def predict(self, x) -> np.ndarray:
        return np.asarray(self.value)[self.apply(x)]


def _impurity(y: np.ndarray) -> float:
    """The node's variance, as scikit-learn's squared-error criterion."""
    n = y.shape[0]
    mean = y.sum() / n
    return (y * y).sum() / n - mean * mean


def _grow(tree: Tree, x: np.ndarray, y: np.ndarray, idx: np.ndarray,
          depth: int, max_depth: Optional[int], choose) -> int:
    """Grow the subtree over samples ``idx``; ``choose(x_node, y_node)``
    gives (feature, threshold) of the node's split or None."""
    y_node = y[idx]
    node = tree.add(float(y_node.sum() / y_node.shape[0]))
    if idx.shape[0] < 2 or (max_depth is not None and depth >= max_depth) \
            or _impurity(y_node) <= EPSILON:
        return node
    split = choose(x[idx], y_node)
    if split is None:
        return node
    f, thr = split
    go_left = x[idx, f] <= thr
    tree.feature[node], tree.threshold[node] = f, thr
    tree.left[node] = _grow(tree, x, y, idx[go_left], depth + 1, max_depth,
                            choose)
    tree.right[node] = _grow(tree, x, y, idx[~go_left], depth + 1,
                             max_depth, choose)
    return node


def _proxy(sum_left, n_left, sum_right, n_right):
    """The split's variance-reduction proxy (scikit-learn's
    ``proxy_impurity_improvement`` of squared error): larger is better."""
    return sum_left * sum_left / n_left + sum_right * sum_right / n_right


def _best_split(x: np.ndarray, y: np.ndarray, order: np.ndarray):
    """The exhaustive best split of a node: every feature in ``order``,
    every boundary between sorted distinct values, the threshold at the
    midpoint; the first strictly best one wins."""
    best, best_proxy = None, -np.inf
    total = y.sum()
    for f in order:
        srt = np.argsort(x[:, f], kind="stable")
        xf = x[srt, f].astype(np.float64)
        csum = np.cumsum(y[srt])
        for p in range(1, xf.shape[0]):
            if xf[p] <= xf[p - 1] + FEATURE_THRESHOLD:
                continue
            s_left = csum[p - 1]
            proxy = _proxy(s_left, p, total - s_left, xf.shape[0] - p)
            if proxy > best_proxy:
                thr = xf[p - 1] / 2.0 + xf[p] / 2.0
                if thr == xf[p] or np.isinf(thr):
                    thr = xf[p - 1]
                best, best_proxy = (int(f), thr), proxy
    return best


def _random_split(x: np.ndarray, y: np.ndarray, rng: np.random.Generator):
    """Extra-trees split: per feature (in a random order) one uniform
    threshold in [min, max), max mapped back to min; the best of them by
    variance reduction. None where every feature is constant."""
    best, best_proxy = None, -np.inf
    total = y.sum()
    n = y.shape[0]
    for f in rng.permutation(x.shape[1]):
        xf = x[:, f].astype(np.float64)
        lo, hi = xf.min(), xf.max()
        if hi <= lo + FEATURE_THRESHOLD:
            continue
        thr = (hi - lo) * rng.random() + lo
        if thr == hi:
            thr = lo
        go_left = xf <= thr
        n_left = int(go_left.sum())
        if n_left == 0 or n_left == n:
            continue
        s_left = y[go_left].sum()
        proxy = _proxy(s_left, n_left, total - s_left, n - n_left)
        if proxy > best_proxy:
            best, best_proxy = (int(f), thr), proxy
    return best


class ExtraTrees:
    """Extremely randomized trees (see the module doc)."""

    def __init__(self, n_estimators: int = 50, random_state: int = 0):
        self.n_estimators = n_estimators
        self.random_state = random_state

    def fit(self, x, y) -> "ExtraTrees":
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float64)
        rngs = [np.random.default_rng(s) for s in np.random.SeedSequence(
            self.random_state).spawn(self.n_estimators)]
        self.estimators_ = []
        for rng in rngs:
            tree = Tree()
            _grow(tree, x, y, np.arange(x.shape[0]), 0, None,
                  lambda xn, yn, rng=rng: _random_split(xn, yn, rng))
            self.estimators_.append(tree)
        return self

    def predict(self, x) -> np.ndarray:
        return np.mean([t.predict(x) for t in self.estimators_], axis=0)


class GradientBoosting:
    """Least-squares gradient boosting (see the module doc)."""

    def __init__(self, n_estimators: int = 100, learning_rate: float = 0.1,
                 max_depth: int = 3, random_state: int = 0):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.random_state = random_state

    def fit(self, x, y) -> "GradientBoosting":
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.random_state)
        self.init_ = float(np.mean(y))
        raw = np.full(y.shape[0], self.init_)
        self.estimators_ = []
        for _ in range(self.n_estimators):
            residual = y - raw
            tree = Tree()
            _grow(tree, x, residual, np.arange(x.shape[0]), 0,
                  self.max_depth,
                  lambda xn, yn: _best_split(xn, yn,
                                             rng.permutation(x.shape[1])))
            raw += self.learning_rate * np.asarray(tree.value)[
                tree.apply(x)]
            self.estimators_.append(tree)
        return self

    def predict(self, x) -> np.ndarray:
        out = np.full(np.asarray(x).shape[0], self.init_)
        for tree in self.estimators_:
            out += self.learning_rate * tree.predict(x)
        return out
