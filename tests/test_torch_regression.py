"""``loss='gaussian'`` in the port against the JAX package, on ``mlp``.

The regression path: the MLP (``models.build("mlp", D, in_features=F)``,
JAX's ``mlp([128, 64], D)``) with numpy-seeded weights in both packages,
inputs and targets from a synthetic UCI CSV read by each package's
``uci`` loader (a second, three-output head on the same inputs), and
the unit-variance Gaussian Fisher: the loss and its cotangent, KFAC,
Diagonal and EFB updated with injected [S, B, D] targets (EFB given JAX's
eigenvectors: eigh picks its basis freely inside degenerate eigenspaces),
the Monte-Carlo targets' distribution, the Laplace evidence of
``loss='gaussian'`` and the regression predictive (sampled and
linearized) on JAX's ensemble draws. Tolerances are relative to the max
of the JAX value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.data import loaders as jloaders
from curvature_tpu.estimators import capture as jcapture
from curvature_tpu.eval import marglik as jml
from curvature_tpu.eval import predictive as jpred
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.estimators import capture as tcapture
from curvature_tpu_torch.eval import marglik as tml
from curvature_tpu_torch.eval import predictive as tpred

torch.set_num_threads(2)

FEATURES, ROWS, SAMPLES = 8, 200, 6
DAMPING = (1.0, 50.0)


def _close(got, want, rel, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _to_port(tree):
    return tmodels.state_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                  "cpu")


@pytest.fixture(scope="module")
def uci_root(tmp_path_factory):
    """``<root>/uci/concrete.csv``: a header row, FEATURES inputs and a
    target that is a noisy nonlinear function of them."""
    root = tmp_path_factory.mktemp("uci")
    (root / "uci").mkdir()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ROWS, FEATURES))
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] * x[:, 2] \
        + 0.1 * rng.standard_normal(ROWS)
    with open(root / "uci" / "concrete.csv", "w") as f:
        f.write(",".join([f"x{i}" for i in range(FEATURES)] + ["y"]) + "\n")
        for row in np.column_stack([x, y]):
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    return root


def _pair(outputs, seed=0):
    tm = tmodels.build("mlp", outputs, device="cpu", in_features=FEATURES)
    variables = tmodels.seeded_variables(tm, seed)
    tmodels.load_jax_variables(tm, variables)
    jm = jmodels.build("mlp", outputs)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, FEATURES), jnp.float32)))
    return tm, jm, jax.tree_util.tree_map(jnp.asarray, variables)


@pytest.fixture(scope="module", params=[1, 3])
def fitted(request, uci_root):
    """Both packages' estimators updated on the UCI training split in
    batches of 60 with two injected target draws each: D=1 (the CSV's
    target), D=3 (the target and two functions of it)."""
    d = request.param
    (xtr, ytr), (xte, yte) = tloaders.uci(str(uci_root), "concrete")
    (jx, jy), _ = jloaders.uci(str(uci_root), "concrete")
    np.testing.assert_array_equal(xtr, jx)
    np.testing.assert_array_equal(ytr, jy)

    def targets(y):
        return np.stack([y, np.tanh(y), 0.5 * y ** 2][:d], axis=-1) \
            .astype(np.float32)
    train = [(xtr[i:i + 60], targets(ytr[i:i + 60]))
             for i in range(0, len(xtr), 60)]
    test = [(xte, targets(yte))]
    tm, jm, jv = _pair(d)
    rng = np.random.default_rng(1)
    draws = [y[None] + rng.standard_normal((2,) + y.shape).astype(np.float32)
             for _, y in train]
    je = {"kfac": jest.KFAC(jm, jv, use_pallas=False, loss="gaussian"),
          "diag": jest.Diagonal(jm, jv, loss="gaussian")}
    te = {"kfac": port_est.KFAC(tm, loss="gaussian"),
          "diag": port_est.Diagonal(tm, loss="gaussian")}
    for (x, _), lab in zip(train, draws):
        for kind in ("kfac", "diag"):
            je[kind].update(jnp.asarray(x), labels=jnp.asarray(lab))
            te[kind].update(torch.from_numpy(x), labels=torch.from_numpy(lab))
    je["efb"] = jest.EFB(jm, jv, je["kfac"].state, loss="gaussian")
    te["efb"] = port_est.EFB(tm, _to_port(je["kfac"].state), loss="gaussian")
    te["efb"].eigvecs = _to_port(je["efb"].eigvecs)
    for (x, _), lab in zip(train, draws):
        je["efb"].update(jnp.asarray(x), labels=jnp.asarray(lab))
        te["efb"].update(torch.from_numpy(x), labels=torch.from_numpy(lab))
    return dict(d=d, tm=tm, jm=jm, jv=jv, je=je, te=te, train=train,
                test=test, draws=draws)


def test_gaussian_loss_and_cotangent_match_jax():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((5, 3)).astype(np.float32)
    y = rng.standard_normal((2, 5, 3)).astype(np.float32)
    _close(tcapture.gaussian_nll(torch.from_numpy(f), torch.from_numpy(y[0])),
           jcapture.gaussian_nll(jnp.asarray(f), jnp.asarray(y[0])), 1e-6)
    want = jax.vmap(jcapture._gaussian_cotangent, in_axes=(None, 0))(
        jnp.asarray(f), jnp.asarray(y))
    _close(tcapture.gaussian_cotangent(torch.from_numpy(f),
                                       torch.from_numpy(y)), want, 1e-6)


@pytest.mark.parametrize("kind", ["kfac", "diag", "efb"])
def test_gaussian_factors_match_jax(fitted, kind):
    """Every layer's state after the updates: KFAC's A and G, Diagonal's
    weight and bias squares, EFB's lambdas (in JAX's eigenbasis), within
    1e-5 of max."""
    t, j = fitted["te"][kind], fitted["je"][kind]
    want = _to_port(j.state)
    assert list(t.metas) == list(j.metas) == ["fc1", "fc2", "fc3"]
    for layer, fac in want.items():
        if not isinstance(fac, dict):
            fac, got = {"": fac}, {"": t.state[layer]}
        else:
            got = t.state[layer]
        for key, val in fac.items():
            _close(got[key], val, 1e-5, f"{kind} {layer} {key}")


def test_monte_carlo_targets_are_unit_gaussian_around_the_outputs(fitted):
    """Without labels, a draw is the outputs plus standard-normal noise,
    [S, B, D] (JAX :103-106); an update on them gives finite factors whose
    last-layer G is a multiple of the identity, E[(f - y)(f - y)^T] = I,
    within 0.05 (400 draws of 60 rows)."""
    tm, x = fitted["tm"], torch.from_numpy(fitted["train"][0][0])
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        f = tm(x)
    draws = tcapture.sample_labels(f, 4000, gen, "gaussian")
    assert draws.shape == (4000,) + tuple(f.shape)
    eps = (draws - f).reshape(-1, fitted["d"])
    assert abs(float(eps.mean())) < 0.01
    assert abs(float(eps.std()) - 1.0) < 0.01
    est = port_est.KFAC(tm, loss="gaussian")
    est.update(x, generator=gen, num_samples=400)
    g = est.state["fc3"]["g"]
    _close(g / g.diagonal().mean(), np.eye(fitted["d"], dtype=np.float32),
           0.05, "E[G]")
    assert all(torch.isfinite(v).all() for s in est.state.values()
               for v in s.values())


@pytest.mark.parametrize("kind", ["kfac", "diag"])
def test_gaussian_evidence_matches_jax(fitted, kind):
    """The Laplace evidence of ``loss='gaussian'``: the MAP NLL over the
    training split (0.5 ||y - f||^2 + D/2 log 2pi a row) and the
    log-determinant of the damped precision, 1e-5 relative."""
    jnll = jml.dataset_map_nll(fitted["jm"], fitted["jv"], fitted["train"],
                               loss="gaussian")
    tnll = tml.dataset_map_nll(fitted["tm"], [
        (torch.from_numpy(x), y) for x, y in fitted["train"]],
        loss="gaussian")
    assert abs(tnll - jnll) <= 1e-5 * abs(jnll)
    want = jml.log_marginal_likelihood(fitted["je"][kind], jnll, *DAMPING)
    got = tml.log_marginal_likelihood(fitted["te"][kind], tnll, *DAMPING)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _jax_noise(t, seed, samples):
    """The standard-normal draws of JAX's ``ensemble_params(PRNGKey(seed),
    samples)``: one key per sample, then one per layer in meta order."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(seed), samples):
        noise = {}
        for name, shape in t.noise_shapes().items():
            key, k = jax.random.split(key)
            noise[name] = np.array(jax.random.normal(k, shape, jnp.float32))
        out.append(noise)
    return out


@pytest.mark.parametrize("linearized", [True, False])
def test_regression_predictive_matches_jax(fitted, linearized):
    """``eval_bnn_regression`` after KFAC's invert: means, variances
    (with the observation noise) and targets 1e-5 of max, the ensemble
    built from JAX's draws."""
    je, te = fitted["je"]["kfac"], fitted["te"]["kfac"]
    je.invert(*DAMPING)
    te.invert(*DAMPING)
    ens = te.ensemble_params(SAMPLES, noise=_jax_noise(te, 5, SAMPLES))
    want = jpred.eval_bnn_regression(fitted["jm"], fitted["jv"], je,
                                     fitted["test"], SAMPLES,
                                     jax.random.PRNGKey(5),
                                     linearized=linearized)
    got = tpred.eval_bnn_regression(fitted["tm"], te, [
        (torch.from_numpy(x), y) for x, y in fitted["test"]], SAMPLES,
        ensemble_params=ens, linearized=linearized)
    for g, w, what in zip(got, want, ("mean", "var", "targets")):
        _close(g, w, 1e-5, what)
    assert (got[1] >= 1.0).all()


def test_label_ranks():
    """[B, D] targets are one draw, [S, B, D] S draws; an unknown loss
    raises."""
    tm, _, _ = _pair(2)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, FEATURES)).astype(np.float32))
    y = torch.zeros((5, 2))
    one = tcapture.collect(tm, tm.metas, x, labels=y, loss="gaussian",
                           need_param_grads=False)
    two = tcapture.collect(tm, tm.metas, x, labels=torch.stack([y, y]),
                           loss="gaussian", need_param_grads=False)
    assert one.probe_grads["fc3"].shape == (1, 5, 2)
    assert two.probe_grads["fc3"].shape == (2, 5, 2)
    assert one.batch_size == 5
    with pytest.raises(ValueError, match="unknown loss"):
        tcapture.collect(tm, tm.metas, x, labels=y, loss="poisson")
