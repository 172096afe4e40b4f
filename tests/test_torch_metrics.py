"""The port's metrics (curvature_tpu_torch/eval/metrics.py) against the
JAX package's on the same seeded inputs, one case per function; float32
inputs, 1e-6 relative unless stated."""
import numpy as np
import pytest
import torch

from curvature_tpu.eval import metrics as jm
from curvature_tpu_torch.eval import metrics as tm

N, K = 300, 10


def _probs(seed, temp=2.0):
    rng = np.random.default_rng(seed)
    logits = temp * rng.standard_normal((N, K)).astype(np.float32)
    p = np.exp(logits - logits.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)).astype(np.float32), \
        rng.integers(0, K, N)


def _np(v):
    if torch.is_tensor(v):
        return v.numpy()
    return np.asarray(v)


def _same(got, want, rel=1e-6):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rel)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=rel,
                               atol=rel * max(np.abs(w).max(), 1e-12)
                               if w.size else 0)


def _factor(rng, n):
    a = rng.standard_normal((n, n)).astype(np.float32)
    return a @ a.T


CASES = {
    "confidence": lambda p, y, r: ((p,), {}),
    "confidence_per_row": lambda p, y, r: ((p,), {"mean": False}),
    "ece_from_confidence": lambda p, y, r: (
        (p.max(1), (p.argmax(1) == y).astype(np.float32)), {"bins": 15}),
    "expected_calibration_error": lambda p, y, r: ((p, y), {}),
    "calibration_curve": lambda p, y, r: ((p, y), {}),
    "binned_kl_distance": lambda p, y, r: ((p[:, 0], p[:, 1]), {}),
    "linear_interpolation": lambda p, y, r: ((-1.0, 3.0, p[:, 2]), {}),
    "rmse": lambda p, y, r: ((p[:, :3], p[:, 3:6]), {}),
    "gaussian_nll": lambda p, y, r: ((p[:, :3], p[:, 3:6] + 0.1,
                                      p[:, 6:9]), {}),
    "auroc": lambda p, y, r: ((p[:150, 0], p[150:, 0]), {}),
    "auroc_with_ties": lambda p, y, r: ((np.round(p[:150, 0], 1),
                                         np.round(p[150:, 0], 1)), {}),
    "get_eigenvalues": lambda p, y, r: (({
        "conv": {"a": _factor(r, 7), "g": _factor(r, 4)},
        "fc": r.standard_normal((3, 5)).astype(np.float32)},), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case):
    name = case.replace("_per_row", "").replace("_with_ties", "")
    p, y = _probs(1)
    args, kw = CASES[case](p, y, np.random.default_rng(2))
    want = getattr(jm, name)(*args, **kw)
    got = getattr(tm, name)(*args, **kw)
    # eigvalsh of float32 factors: LAPACK's and XLA's roundoff differ
    _same(got, want, 2e-5 if name == "get_eigenvalues" else 1e-6)
