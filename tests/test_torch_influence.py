"""Inverse-vector products (``precision_solve``) and influence functions
(``eval/influence.py``) of the port.

JAX ``tests/test_influence.py``'s cases over every estimator (Diagonal,
BlockDiagonal, KFAC, EFB, INF, Subspace) on the MLP, the grouped net and
the depth-scanned ViT of ``tests/torch_exact.py``:
``quadratic_form(solve(v)) == <v, solve(v)>`` and the roundtrip
``solve(P v) == v`` with ``P v`` the autograd gradient of ``0.5 *
quad_state``. Then the port against the JAX package: per-example
gradients (the BatchNorm net too), ``influence_scores`` and
``self_influence`` with JAX's fitted states fed to the port
(``models.state_from_jax``). Each test states its tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu.eval import influence as jinf
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.estimators.base import normalize_damping
from curvature_tpu_torch.eval import influence as tinf
from curvature_tpu_torch.ops import matfree as tmf

from tests.torch_exact import (
    SHAPES, close, jv, np_, pair, running_stats)

torch.set_num_threads(1)

ADD, MULT = 0.7, 3.0
ALL = ["diag", "block", "kfac", "efb", "inf", "subspace"]
ARCHS = ["mlp", "grouped", "stacked"]


def _labels(arch, seed=1, samples=2):
    shape, classes = SHAPES[arch]
    return np.random.default_rng(seed).integers(
        0, classes, (samples, shape[0])).astype(np.int32)


def _fit_port(name, tm, tx, labels):
    """The port's estimator ``name`` fitted on the injected ``labels``."""
    labels = torch.from_numpy(labels)
    if name == "subspace":
        est = port_est.Subspace(tm, rank=12)
        est.update(tx)
        return est
    if name in ("efb", "inf"):
        kfac = port_est.KFAC(tm)
        kfac.update(tx, labels=labels)
        efb = port_est.EFB(tm, kfac.state)
        efb.update(tx, labels=labels)
        if name == "efb":
            return efb
        diag = port_est.Diagonal(tm)
        diag.update(tx, labels=labels)
        est = port_est.INF(tm, diag.state, kfac.state, efb.state,
                           eigvecs=efb.eigvecs)
        est.update(rank=10)
        return est
    est = {"diag": port_est.Diagonal, "block": port_est.BlockDiagonal,
           "kfac": port_est.KFAC}[name](tm)
    est.update(tx, labels=labels)
    return est


@pytest.fixture(scope="module")
def models_():
    return {arch: pair(arch) for arch in ARCHS + ["bn"]}


def _probe(est, seed=0):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in tmf.delta_shapes(est.metas).items()}


@pytest.mark.parametrize("name", ALL)
def test_solve_matches_quadratic_form(name, models_):
    """u = P^{-1} v: u^T P u equals <v, u> within 2e-3 relative (JAX's
    bar), and P^{-1} is positive definite."""
    tm, _, _, _, tx = models_["mlp"]
    est = _fit_port(name, tm, tx, _labels("mlp"))
    v = _probe(est)
    u = est.precision_solve(v, ADD, MULT)
    inner = sum(float((v[n] * u[n]).sum()) for n in est.metas)
    q = est.quadratic_form(u, ADD, MULT)
    np.testing.assert_allclose(q, inner, rtol=2e-3)
    assert inner > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ALL)
def test_solve_roundtrip_against_quad_gradient(name, arch, models_):
    """solve(P v) == v with P v = grad(0.5 * quad_state)(v) by autograd:
    2e-3 relative, 2e-4 absolute (JAX's bars); the grouped and stacked
    nets reach the per-group and [depth, ...] branches of every
    solve_state."""
    tm, _, _, _, tx = models_[arch]
    est = _fit_port(name, tm, tx, _labels(arch))
    add, mult = normalize_damping(ADD, MULT, len(est.metas))
    v = _probe(est, seed=1)
    pv = torch.func.grad(
        lambda d: 0.5 * est.quad_state(est.state, add, mult, d))(v)
    back = est.precision_solve(pv, ADD, MULT)
    for n in est.metas:
        np.testing.assert_allclose(np_(back[n]), np_(v[n]), rtol=2e-3,
                                   atol=2e-4, err_msg=n)


def _y(seed=3, n=16, classes=4):
    return np.random.default_rng(seed).integers(0, classes, n)


def test_influence_self_pair_is_helpful(models_):
    """A training example's influence on its own loss is negative."""
    tm, _, _, _, tx = models_["mlp"]
    y = _y()
    est = port_est.KFAC(tm)
    est.update(tx, labels=torch.from_numpy(y)[None])
    scores = tinf.influence_scores(est, tx, y, tx[3:4], y[3:4], add=ADD,
                                   multiply=MULT)
    assert scores.shape == (16,)
    assert float(scores[3]) < 0


def test_self_influence_positive(models_):
    tm, _, _, _, tx = models_["mlp"]
    y = _y()
    est = port_est.Diagonal(tm)
    est.update(tx, labels=torch.from_numpy(y)[None])
    s = tinf.self_influence(est, tx, y, add=ADD, multiply=MULT)
    assert s.shape == (16,) and (s > 0).all()


def test_influence_matches_manual_inner_product(models_):
    """influence == -<g_i, P^{-1} g_test> from the exported helpers: 1e-5
    relative."""
    tm, _, _, _, tx = models_["mlp"]
    y = _y()
    est = port_est.BlockDiagonal(tm)
    est.update(tx, labels=torch.from_numpy(y)[None])
    scores = tinf.influence_scores(est, tx, y, tx[:2], y[:2], add=ADD,
                                   multiply=MULT)
    g_test = tinf.loss_grad_matrix(tm, est.metas, tx[:2], y[:2])
    solved = est.precision_solve(g_test, ADD, MULT)
    grads = tinf.per_example_grad_matrix(tm, est.metas, tx, y)
    want = -sum(np_(torch.einsum("n...,...->n", grads[n], solved[n]))
                for n in est.metas)
    np.testing.assert_allclose(np_(scores), want, rtol=1e-5)


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("arch", ["mlp", "bn", "grouped", "stacked"])
def test_per_example_grads_match_jax(arch, models_):
    """The vmapped per-example gradients (train-mode BatchNorm on single
    examples) and the batch gradient: 1e-5 of max of JAX's; no running
    statistic moves."""
    tm, jm, variables, x, tx = models_[arch]
    y = _labels(arch, seed=4, samples=1)[0]
    metas = port_est.Diagonal(tm).metas
    jmetas = jest.Diagonal(jm, jv(variables)).metas
    before = running_stats(tm)
    want = jinf.per_example_grad_matrix(jm, jmetas, jv(variables),
                                        jnp.asarray(x), jnp.asarray(y))
    got = tinf.per_example_grad_matrix(tm, metas, tx, y)
    for n in want:
        close(got[n], want[n], 1e-5, n)
    want = jinf.loss_grad_matrix(jm, jmetas, jv(variables), jnp.asarray(x),
                                 jnp.asarray(y))
    got = tinf.loss_grad_matrix(tm, metas, tx, y)
    for n in want:
        close(got[n], want[n], 1e-5, n)
    for k, v in running_stats(tm).items():
        assert torch.equal(v, before[k]), k


def _fit_both(name, arch, models_):
    """JAX's estimator fitted on seeded labels (Subspace: on its own
    omega) and the port's fed its state."""
    tm, jm, variables, x, tx = models_[arch]
    labels = jnp.asarray(_labels(arch))
    jvars = jv(variables)
    xj = jnp.asarray(x)

    def to_port(state):
        return tmodels.state_from_jax(state, "cpu")
    if name == "subspace":
        je = jest.Subspace(jm, jvars, rank=12)
        je.update(xj, rng=jax.random.PRNGKey(2))
        te = port_est.Subspace(tm, omega={
            n: np.array(v["omega"]) for n, v in je.state.items()})
        te.state = to_port(je.state)
        return je, te
    if name in ("efb", "inf"):
        kfac = jest.KFAC(jm, jvars, use_pallas=False)
        kfac.update(xj, labels=labels)
        efb = jest.EFB(jm, jvars, kfac.state)
        efb.update(xj, labels=labels)
        tefb = port_est.EFB(tm, to_port(kfac.state))
        tefb.state = to_port(efb.state)
        tefb.eigvecs = to_port(efb.eigvecs)
        if name == "efb":
            return efb, tefb
        diag = jest.Diagonal(jm, jvars)
        diag.update(xj, labels=labels)
        je = jest.INF(jm, jvars, diag.state, kfac.state, efb.state,
                      eigvecs=efb.eigvecs)
        je.update(rank=10)
        te = port_est.INF(tm, to_port(diag.state), to_port(kfac.state),
                          to_port(efb.state), eigvecs=to_port(efb.eigvecs))
        te.state = to_port(je.state)
        return je, te
    je = {"diag": lambda: jest.Diagonal(jm, jvars),
          "block": lambda: jest.BlockDiagonal(jm, jvars),
          "kfac": lambda: jest.KFAC(jm, jvars, use_pallas=False)}[name]()
    je.update(xj, labels=labels)
    te = {"diag": port_est.Diagonal, "block": port_est.BlockDiagonal,
          "kfac": port_est.KFAC}[name](tm)
    te.state = to_port(je.state)
    return je, te


@pytest.mark.parametrize("name", ALL)
def test_influence_scores_match_jax(name, models_):
    """Each training example's influence on two test examples' loss, the
    estimator's state JAX's: 1e-4 of max."""
    _, _, _, x, tx = models_["mlp"]
    je, te = _fit_both(name, "mlp", models_)
    y = _y()
    want = jinf.influence_scores(je, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(x[:2]), jnp.asarray(y[:2]),
                                 add=ADD, multiply=MULT)
    got = tinf.influence_scores(te, tx, y, tx[:2], y[:2], add=ADD,
                                multiply=MULT)
    close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ["mlp", "grouped"])
@pytest.mark.parametrize("name", ALL)
def test_self_influence_matches_jax(name, arch, models_):
    """g_i^T P^{-1} g_i of every example (one invert, solve_state vmapped
    over the examples), the estimator's state JAX's: 1e-4 of max."""
    _, _, _, x, tx = models_[arch]
    je, te = _fit_both(name, arch, models_)
    y = _labels(arch, seed=5, samples=1)[0]
    want = jinf.self_influence(je, jnp.asarray(x), jnp.asarray(y), add=ADD,
                               multiply=MULT)
    got = tinf.self_influence(te, tx, y, add=ADD, multiply=MULT)
    close(got, want, 1e-4)
