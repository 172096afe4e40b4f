"""The Laplace evidence (``eval/marglik.py``) of the port against the JAX
package, for all five estimators.

LeNet-5 with the bundled weights on two batches of 64 bundled digits: the
JAX estimators (KFAC, Diagonal, Block on ``conv1`` and ``fc3``, EFB, INF
at rank 20) are updated on the first batch with seeded labels, and their
states (EFB's eigenvectors too) are fed to the port through
``models.state_from_jax``. The evidence, its gradient-ascent tuning
(optax's Adam against ``torch.optim.Adam``) and autograd through every
``logdet_state`` (against central finite differences in float64) are
checked. Each test states its tolerance.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu.eval import marglik as jml
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.eval import marglik as tml
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

ARGV = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
        "--data_dir", tloaders.FIXTURE_DIR, "--batch_size", "64"]
KINDS = ("kfac", "diag", "block", "efb", "inf")
BLOCK_LAYERS = ["conv1", "fc3"]
ADD, MULTIPLY = 10.0, 1e3
RANK = 20


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_port(state, dtype=torch.float32):
    return tmodels.state_from_jax(state, "cpu", dtype)


@pytest.fixture(scope="module")
def fitted():
    t, j = tconfig.parse_args(ARGV), jconfig.parse_args(ARGV)
    tm = tcommon.build_model(t)
    jm, jv = jcommon.build_model(j)
    train = list(tcommon.build_data(t, splits="train"))[:2]
    x = jnp.asarray(train[0][0])
    labels = jnp.asarray(np.random.default_rng(0).integers(
        0, 10, (1, x.shape[0])).astype(np.int32))
    je = {"kfac": jest.KFAC(jm, jv, use_pallas=False),
          "diag": jest.Diagonal(jm, jv),
          "block": jest.BlockDiagonal(jm, jv, layer_filter=BLOCK_LAYERS)}
    for e in je.values():
        e.update(x, labels=labels)
    je["efb"] = jest.EFB(jm, jv, je["kfac"].state)
    je["efb"].update(x, labels=labels)
    je["inf"] = jest.INF(jm, jv, je["diag"].state, je["kfac"].state,
                         je["efb"].state, eigvecs=je["efb"].eigvecs)
    je["inf"].update(rank=RANK)

    kfac_state = _to_port(je["kfac"].state)
    te = {"kfac": port_est.KFAC(tm), "diag": port_est.Diagonal(tm),
          "block": port_est.BlockDiagonal(tm, layer_filter=BLOCK_LAYERS),
          "efb": port_est.EFB(tm, kfac_state)}
    for kind in ("kfac", "diag", "block", "efb"):
        te[kind].state = _to_port(je[kind].state)
    te["efb"].eigvecs = _to_port(je["efb"].eigvecs)
    te["inf"] = port_est.INF(tm, _to_port(je["diag"].state), kfac_state,
                             _to_port(je["efb"].state),
                             eigvecs=_to_port(je["efb"].eigvecs))
    te["inf"].state = _to_port(je["inf"].state)
    for kind in KINDS:
        assert list(te[kind].metas) == list(je[kind].metas), kind
    return dict(tm=tm, jm=jm, jv=jv, train=train, je=je, te=te,
                nchw=[(_nchw(a), b) for a, b in train])


def test_dataset_map_nll_matches_jax(fitted):
    """The summed MAP NLL over 128 digits: 1e-5 relative."""
    want = jml.dataset_map_nll(fitted["jm"], fitted["jv"], fitted["train"])
    got = tml.dataset_map_nll(fitted["tm"], fitted["nchw"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_dataset_map_nll_gaussian_matches_jax(fitted):
    """``loss='gaussian'`` on one-hot targets: 1e-5 relative."""
    data_j = [(x, np.eye(10, dtype=np.float32)[y])
              for x, y in fitted["train"]]
    data_t = [(xt, yt) for (xt, _), (_, yt) in zip(fitted["nchw"], data_j)]
    want = jml.dataset_map_nll(fitted["jm"], fitted["jv"], data_j,
                               loss="gaussian")
    got = tml.dataset_map_nll(fitted["tm"], data_t, loss="gaussian")
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_covered_params_match_jax(fitted, kind):
    """Counts exactly, squared norms 1e-6 relative."""
    wc, ws = jml.covered_params(fitted["je"][kind])
    gc, gs = tml.covered_params(fitted["te"][kind])
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)


@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_log_marginal_likelihood_matches_jax(fitted, kind, per_layer):
    """The evidence at a shared and a per-layer damping within 1e-5 of
    the evidence's term scale (``_term_scale``). Block's logdet is float64
    in the port and f32 in JAX, whose Cholesky fails (NaN) at multiply 5e4
    on LeNet-5's fc3 block: the damping stays at multiply <= 1e4."""
    je, te = fitted["je"][kind], fitted["te"][kind]
    nll = 123.25
    n = len(je.metas)
    add = np.linspace(5.0, 20.0, n) if per_layer else ADD
    mult = np.geomspace(1e2, 1e4, n) if per_layer else MULTIPLY
    want = jml.log_marginal_likelihood(je, nll, add, mult)
    got = tml.log_marginal_likelihood(te, nll, add, mult)
    assert abs(got - want) <= 1e-5 * _term_scale(te, add, mult, nll), \
        (got, want)


def test_log_marginal_likelihood_needs_positive_prior(fitted):
    with pytest.raises(ValueError, match="add > 0"):
        tml.log_marginal_likelihood(fitted["te"]["diag"], 0.0, 0.0, 1.0)


def _as64(est):
    """A shallow copy of a port estimator with its state in float64."""
    out = copy.copy(est)
    out.dtype = torch.float64

    def conv(s):
        return {k: conv(v) for k, v in s.items()} if isinstance(s, dict) \
            else s.double()
    out.state = conv(est.state)
    return out


@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_logdet_gradient_matches_finite_differences(fitted, kind, per_layer):
    """d logdet_state / d(log10 add, log10 multiply) by autograd
    (Cholesky, eigh and the float64 work of INF's R x R Gram included)
    against central differences with step 1e-5, all in float64: 1e-6
    relative to the gradient's max."""
    est = _as64(fitted["te"][kind])
    n = len(est.metas)
    shape = (2, n) if per_layer else (2,)
    base = torch.zeros(shape, dtype=torch.float64)
    base[0] += 0.3
    base[1] += 4.0

    def f(p):
        add = (10.0 ** p[0]).expand(n)
        mult = (10.0 ** p[1]).expand(n)
        return est.logdet_state(est.state, add, mult)
    p = base.clone().requires_grad_(True)
    f(p).backward()
    grad = p.grad.numpy().ravel()
    h = 1e-5
    fd = []
    for i in range(base.numel()):
        e = torch.zeros(base.numel(), dtype=torch.float64)
        e[i] = h
        e = e.reshape(shape)
        with torch.no_grad():
            fd.append(float(f(base + e) - f(base - e)) / (2 * h))
    np.testing.assert_allclose(grad, fd, atol=1e-6 * np.abs(fd).max())


def _term_scale(est, add, multiply, nll=0.0) -> float:
    """The summed magnitudes of the evidence's terms at (add, multiply):
    |NLL| + (1/2) sum d_l |log add_l| + (1/2) sum add_l ||theta_l||^2 +
    (1/2) |logdet|. The evidence is their signed sum, far smaller where
    they cancel (EFB on LeNet-5 tunes to ~100 from terms of ~70,000), and
    each package's f32 sums of up to 61,706 log terms round on their
    scale."""
    counts, sq = tml.covered_params(est)
    n = len(est.metas)
    add = np.broadcast_to(np.asarray(add, np.float64), (n,))
    mult = np.broadcast_to(np.asarray(multiply, np.float64), (n,))
    return abs(nll) + 0.5 * float(np.sum(counts * np.abs(np.log(add))
                                         + add * sq)) \
        + 0.5 * abs(est.logdet_precision(add, mult))


@pytest.mark.parametrize("kind,per_layer", [
    (k, False) for k in KINDS] + [("kfac", True), ("diag", True),
                                  ("efb", True)])
def test_gradient_tune_matches_jax(fitted, kind, per_layer):
    """``marglik_gradient_tune``, 20 Adam steps from (0, 0), against JAX:
    the trace of negative evidences within 1e-4 of the evidence's term
    scale (``_term_scale``, the larger of the start's and the tuned
    damping's), the final evidence within 1e-5 of it, the tuned damping
    within 1e-3 in log10 units, a hundredth of one Adam step (lr 0.1):
    Adam's normalized steps follow the sign of gradients that the f32
    sums round near the optimum."""
    je, te = fitted["je"][kind], fitted["te"][kind]
    nll = 500.0
    want = jml.marglik_gradient_tune(je, nll, steps=20, per_layer=per_layer)
    got = tml.marglik_gradient_tune(te, nll, steps=20, per_layer=per_layer)
    scale = max(_term_scale(te, 1.0, 1.0, nll),
                _term_scale(te, want["norms"], want["scales"], nll))
    np.testing.assert_allclose(got["trace"], want["trace"],
                               atol=1e-4 * scale)
    for k in ("norms", "scales"):
        np.testing.assert_allclose(np.log10(got[k]), np.log10(want[k]),
                                   atol=1e-3)
    assert abs(got["log_marglik"] - want["log_marglik"]) <= 1e-5 * scale
    # ascent: the evidence rose from the start
    assert got["trace"][-1] < got["trace"][0]
