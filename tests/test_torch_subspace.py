"""The Nyström subspace (global low-rank) Laplace estimator
(``estimators/subspace.py``) of the port.

JAX ``tests/test_subspace.py``'s non-mesh cases: at full sketch width
(R = p) the Nyström approximation is exact, so log-determinant, quadratic
form and the sampling covariance are held against a dense P = D + M^{1/2}
F M^{1/2}, F assembled column by column from ``ops/matfree.ggn_matvec``
(a second code path: one matvec per column against the estimator's
vmapped sketch columns). Then parity with the JAX package on the same
omega (JAX's draw injected) over the model pairs of
``tests/torch_exact.py``: the sketch, and the quantities that do not
depend on the eigenbasis Nyström picks (lam, logdet, quad, solve, the
sampling square root), and a JAX-written subspace factor file loaded into
the port. Each test states its tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.estimators.base import normalize_damping as j_damping
from curvature_tpu.utils import checkpoint as jckpt
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import laplace as tlaplace
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.eval.fidelity import fidelity_report
from curvature_tpu_torch.eval.marglik import log_marginal_likelihood
from curvature_tpu_torch.ops import matfree as tmf
from curvature_tpu_torch.utils import checkpoint as tckpt

from tests.torch_exact import (
    ARCHS, close, jv, np_, pair, running_stats, to_jax, to_torch)

torch.set_num_threads(1)

ADD, MULT = 0.7, 3.0


@pytest.fixture(scope="module")
def problem():
    """The MLP pair, its tracked layers and the dense F (float32)."""
    tm, jm, variables, x, tx = pair("mlp")
    metas = port_est.Diagonal(tm).metas
    shapes = tmf.delta_shapes(metas)
    names = list(shapes)
    sizes = [int(np.prod(shapes[n])) for n in names]
    p = sum(sizes)

    def unflat(v):
        out, i = {}, 0
        for n, s in zip(names, sizes):
            out[n] = torch.as_tensor(np.asarray(v[i:i + s]),
                                     dtype=torch.float32).reshape(shapes[n])
            i += s
        return out

    def flat(d):
        return np.concatenate([np_(d[n]).reshape(-1) for n in names])

    F = np.stack([flat(tmf.ggn_matvec(tm, metas, tx, unflat(np.eye(p)[j])))
                  for j in range(p)], axis=1).astype(np.float64)
    F = (F + F.T) / 2
    return dict(tm=tm, jm=jm, variables=variables, x=x, tx=tx, names=names,
                sizes=sizes, p=p, unflat=unflat, flat=flat, F=F)


@pytest.fixture(scope="module")
def fitted(problem):
    est = port_est.Subspace(problem["tm"], rank=10 ** 6)    # clips to p
    est.update(problem["tx"])
    return est


def _sqrt_matrix(est, inv, problem):
    p = problem["p"]
    return np.stack([problem["flat"](est._apply_sqrt(
        inv, problem["unflat"](np.eye(p)[j]))) for j in range(p)], axis=1)


def test_rank_clips_to_param_count(problem, fitted):
    assert fitted.rank == problem["p"]
    assert all(v["omega"].shape[0] == problem["p"]
               for v in fitted.state.values())


def test_sketch_is_exact_ggn_product(problem, fitted):
    """The vmapped sketch columns against F @ Omega from one matvec per
    column: 1e-4 of max."""
    names, p, flat = problem["names"], problem["p"], problem["flat"]
    om = np.stack([flat({n: fitted.state[n]["omega"][r] for n in names})
                   for r in range(p)], axis=1)
    y = np.stack([flat({n: fitted.state[n]["sketch"][r] for n in names})
                  for r in range(p)], axis=1)
    close(y, problem["F"] @ om, 1e-4)


def test_logdet_matches_dense(problem, fitted):
    p, F = problem["p"], problem["F"]
    want = np.linalg.slogdet(MULT * F + ADD * np.eye(p))[1]
    np.testing.assert_allclose(fitted.logdet_precision(ADD, MULT), want,
                               rtol=5e-3)


def test_quadratic_form_matches_dense(problem, fitted):
    p, F = problem["p"], problem["F"]
    delta = problem["unflat"](np.random.default_rng(0).normal(size=p))
    dv = problem["flat"](delta)
    want = dv @ (MULT * F + ADD * np.eye(p)) @ dv
    np.testing.assert_allclose(fitted.quadratic_form(delta, ADD, MULT), want,
                               rtol=5e-3)


def test_sampling_covariance_is_inverse_precision(problem, fitted):
    """A A^T of the sampling square root against the dense P^{-1}: 5e-3
    of max, as JAX's test."""
    p, F = problem["p"], problem["F"]
    inv = fitted.invert(ADD, MULT)
    a = _sqrt_matrix(fitted, inv, problem)
    want = np.linalg.inv(MULT * F + ADD * np.eye(p))
    close(a @ a.T, want, 5e-3)


def test_per_layer_damping_matches_dense(problem, fitted):
    p, F, sizes = problem["p"], problem["F"], problem["sizes"]
    adds, mults = [0.4, 1.3], [2.0, 0.5]
    d = np.concatenate([np.full(s, a) for s, a in zip(sizes, adds)])
    m = np.concatenate([np.full(s, v) for s, v in zip(sizes, mults)])
    prec = np.diag(d) + np.sqrt(m)[:, None] * F * np.sqrt(m)[None, :]
    np.testing.assert_allclose(fitted.logdet_precision(adds, mults),
                               np.linalg.slogdet(prec)[1], rtol=5e-3)
    delta = problem["unflat"](np.random.default_rng(1).normal(size=p))
    dv = problem["flat"](delta)
    np.testing.assert_allclose(fitted.quadratic_form(delta, adds, mults),
                               dv @ prec @ dv, rtol=5e-3)
    inv = fitted.invert(adds, mults)
    a = _sqrt_matrix(fitted, inv, problem)
    close(a @ a.T, np.linalg.inv(prec), 5e-3)
    # solve is P^{-1} exactly as the sampler's square root gives it
    v = problem["unflat"](np.random.default_rng(2).normal(size=p))
    close(problem["flat"](fitted.precision_solve(v, adds, mults)),
          np.linalg.solve(prec, problem["flat"](v)), 5e-3)


def test_low_rank_is_finite_and_psd(problem):
    est = port_est.Subspace(problem["tm"], rank=8)
    est.update(problem["tx"])
    lam = np_(est.eigenvalues())
    assert lam.shape == (8,) and (lam >= 0).all()
    assert np.isfinite(est.logdet_precision(ADD, MULT))
    est.invert(ADD, MULT)
    draw = est.sample(generator=torch.Generator().manual_seed(7))
    assert all(torch.isfinite(v).all() for v in draw.values())


def test_folded_batches_match_sequential(problem):
    """update_batches over [3, B, ...] equals three update calls, and a
    column chunk of 3 equals the whole vmap: 1e-6 of max."""
    xs = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 16, 5)).astype(np.float32))
    est_a = port_est.Subspace(problem["tm"], rank=8)
    est_a.update_batches(xs)
    est_b = port_est.Subspace(problem["tm"], rank=8, chunk=3)
    for i in range(3):
        est_b.update(xs[i])
    for n in est_a.state:
        torch.testing.assert_close(est_a.state[n]["omega"],
                                   est_b.state[n]["omega"], rtol=0, atol=0)
        close(est_b.state[n]["sketch"], np_(est_a.state[n]["sketch"]),
              1e-6, n)


def test_labels_and_mc_set_only_the_weight(problem):
    """The GGN takes the label expectation analytically: three label sets
    and three MC samples land on the same sketch (1e-6 relative), one
    [B] label set weighs as one sample."""
    est_mc = port_est.Subspace(problem["tm"], rank=6)
    est_mc.update(problem["tx"], generator=torch.Generator().manual_seed(0),
                  num_samples=3)
    est_lbl = port_est.Subspace(problem["tm"], rank=6)
    labels = np.random.default_rng(1).integers(0, 4, (3, 16))
    est_lbl.update(problem["tx"], labels=labels)
    est_one = port_est.Subspace(problem["tm"], rank=6)
    est_one.update(problem["tx"], labels=labels[0])
    for n in est_mc.state:
        close(est_lbl.state[n]["sketch"], np_(est_mc.state[n]["sketch"]),
              1e-6, n)
        close(3 * est_one.state[n]["sketch"], np_(est_mc.state[n]["sketch"]),
              1e-6, n)


def _lm_pair():
    tm = tmodels.gpt2_custom(11, 8, 1, 2, 6, device="cpu")
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    jm = jmodels.gpt2_custom(vocab=11, dim=8, depth=1, heads=2, max_len=6)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 6), jnp.int32)))
    return tm, jm, variables


def test_lm_loss_weighting_matches_jax():
    """loss='lm': [B, T, V] logits flatten to B*T observations, one
    [B, T] label set weighs as ONE sample (not B), MC and labels agree;
    the sketch equals JAX's on JAX's omega within 1e-4 of max."""
    tm, jm, variables = _lm_pair()
    tok = np.random.default_rng(0).integers(0, 11, (4, 6))
    ttok = torch.from_numpy(tok)
    je = jest.Subspace(jm, jv(variables), rank=5, loss="lm")
    je.update(jnp.asarray(tok, jnp.int32), rng=jax.random.PRNGKey(1))
    omega = {n: np.array(v["omega"]) for n, v in je.state.items()}
    est = port_est.Subspace(tm, loss="lm", omega=omega)
    assert est.loss == "lm" and est.rank == 5
    est.update(ttok, generator=torch.Generator().manual_seed(1))
    est_lbl = port_est.Subspace(tm, loss="lm", omega=omega)
    est_lbl.update(ttok, labels=np.random.default_rng(2).integers(
        0, 11, (4, 6)))
    for n in est.state:
        close(est_lbl.state[n]["sketch"], np_(est.state[n]["sketch"]),
              1e-5, n)
        close(est.state[n]["sketch"], je.state[n]["sketch"], 1e-4, n)


def test_ensemble_params_structure(problem):
    est = port_est.Subspace(problem["tm"], rank=4)
    est.update(problem["tx"])
    est.invert(0.5, 1.0)
    ens = est.ensemble_params(3, generator=torch.Generator().manual_seed(5))
    own = dict(problem["tm"].named_parameters())
    assert len(ens) == 3
    for member in ens:
        assert set(member) >= set(own)
        for k, v in own.items():
            assert member[k].shape == v.shape
        assert not torch.equal(member["fc1.weight"], own["fc1.weight"])


def test_layer_filter_restricts_subspace(problem):
    est = port_est.Subspace(problem["tm"], rank=4, layer_filter="last")
    assert list(est.metas) == ["fc2"]
    est.update(problem["tx"])
    est.invert(0.5, 1.0)
    draw = est.sample(generator=torch.Generator().manual_seed(3))
    assert set(draw) == {"fc2"}


def test_marglik_integration(problem):
    """The evidence is finite, and autograd reaches the damping through
    logdet_state."""
    est = port_est.Subspace(problem["tm"], rank=8)
    est.update(problem["tx"])
    assert np.isfinite(log_marginal_likelihood(est, nll_sum=10.0, add=1.0,
                                               multiply=1.0))
    add = torch.tensor([1.0, 2.0], requires_grad=True)
    mult = torch.tensor([1.0, 3.0], requires_grad=True)
    est.logdet_state(est.state, add, mult).backward()
    assert torch.isfinite(add.grad).all() and torch.isfinite(mult.grad).all()


def test_joint_fidelity_captures_cross_layer_curvature(problem, fitted):
    """The full-rank Subspace answers the all-layers row (near-)exactly;
    a layer-local estimator's block sum misses the cross-layer terms."""
    gen = torch.Generator().manual_seed(11)
    rep_sub = fidelity_report(fitted, problem["tx"], gen, num_probes=4,
                              norm=1.0, joint=True)
    assert rep_sub["__joint__"]["scaled_rel_err"] < 2e-2
    block = port_est.BlockDiagonal(problem["tm"])
    block.update(problem["tx"], generator=torch.Generator().manual_seed(0),
                 num_samples=64)
    rep_blk = fidelity_report(block, problem["tx"],
                              torch.Generator().manual_seed(11),
                              num_probes=4, norm=64.0, joint=True)
    assert rep_blk["__joint__"]["scaled_rel_err"] > \
        rep_sub["__joint__"]["scaled_rel_err"]


def test_facade_lowrank(problem):
    labels = np.random.default_rng(1).integers(0, 4, 16)
    la = tlaplace.fit(problem["tm"], [(problem["tx"], labels)],
                      estimator="lowrank", rank=8,
                      generator=torch.Generator().manual_seed(0))
    assert la.estimator.rank == 8
    res = la.optimize_prior_precision(steps=20)
    assert np.isfinite(res["log_marglik"])
    probs = la.predictive(problem["tx"], samples=4)
    assert probs.shape == (16, 4) and np.isfinite(probs).all()


def test_update_leaves_running_statistics():
    """The sketch's train-mode forwards move no BatchNorm statistic."""
    tm, *_, tx = pair("bn")
    before = running_stats(tm)
    est = port_est.Subspace(tm, rank=4)
    est.update(tx)
    for k, v in running_stats(tm).items():
        assert torch.equal(v, before[k]), k


def test_bf16_sketch_near_f32():
    """compute_dtype=bfloat16 runs the products in bf16 (utils/casting)
    and accumulates in f32: on the MLP within 2e-2 of max of the f32
    sketch (the bf16-against-f32 bar of JAX tests/test_capture.py:137;
    1.03e-2 measured). Forward-mode AD keeps the tangents in the
    primal's bf16, where JAX's f32 omega promotes its tangent products to
    f32; through batch-statistics BatchNorm at 4 images the two bf16
    sketches part by up to 0.5 of max (ROADMAP.md, Queue 3)."""
    tm, *_, tx = pair("mlp")
    f32 = port_est.Subspace(tm, rank=4)
    f32.update(tx)
    b16 = port_est.Subspace(tm, rank=4, compute_dtype=torch.bfloat16)
    b16.update(tx)
    for n in f32.state:
        assert b16.state[n]["sketch"].dtype == torch.float32
        close(b16.state[n]["sketch"], np_(f32.state[n]["sketch"]), 2e-2, n)


def test_omega_missing_layers_raise(problem):
    with pytest.raises(ValueError, match="omega lacks"):
        port_est.Subspace(problem["tm"],
                          omega={"fc1": torch.zeros(2, 7, 6)})
    with pytest.raises(ValueError, match="rank"):
        port_est.Subspace(problem["tm"], rank=0)


# -- parity with the JAX package on the same omega ---------------------------

RANKS = {"mlp": 10, "bn": 8, "grouped": 8, "stacked": 6}


@pytest.fixture(scope="module", params=ARCHS)
def twins(request):
    """JAX's Subspace updated on the pair's batch, and the port's on JAX's
    omega; plus JAX's damping and a normal probe."""
    tm, jm, variables, x, tx = pair(request.param)
    je = jest.Subspace(jm, jv(variables), rank=RANKS[request.param])
    je.update(jnp.asarray(x), rng=jax.random.PRNGKey(3))
    te = port_est.Subspace(
        tm, omega={n: np.array(v["omega"]) for n, v in je.state.items()})
    te.update(tx)
    assert list(te.metas) == list(je.metas)
    shapes = tmf.delta_shapes(te.metas)
    rng = np.random.default_rng(4)
    probe = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
    adds = [0.5 + 0.25 * i for i in range(len(shapes))]
    mults = [3.0 - 0.5 * i for i in range(len(shapes))]
    return dict(name=request.param, je=je, te=te, probe=probe, adds=adds,
                mults=mults)


def test_sketch_matches_jax(twins):
    """1e-4 of max per layer (the omega rides along unchanged)."""
    for n, st in twins["je"].state.items():
        close(twins["te"].state[n]["omega"], st["omega"], 0, n)
        close(twins["te"].state[n]["sketch"], st["sketch"], 1e-4, n)


def test_nystrom_eigenvalues_match_jax(twins):
    """lam within 1e-4 of max."""
    close(twins["te"].eigenvalues(), twins["je"].eigenvalues(), 1e-4)


def test_logdet_and_quad_match_jax(twins):
    """logdet and the quadratic form of a normal probe at per-layer
    damping: 1e-4 relative."""
    je, te = twins["je"], twins["te"]
    a, m = twins["adds"], twins["mults"]
    want = je.logdet_precision(a, m)
    assert abs(te.logdet_precision(a, m) - want) <= 1e-4 * abs(want)
    want = float(je.quadratic_form(to_jax(twins["probe"]), a, m))
    got = te.quadratic_form(to_torch(twins["probe"]), a, m)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_solve_and_sqrt_match_jax(twins):
    """precision_solve of a normal probe, and the sampling square root
    applied to that probe and to three basis vectors of each layer: 1e-4
    of max per layer."""
    je, te = twins["je"], twins["te"]
    a, m = twins["adds"], twins["mults"]
    want = je.precision_solve(to_jax(twins["probe"]), a, m)
    got = te.precision_solve(to_torch(twins["probe"]), a, m)
    for n in want:
        close(got[n], want[n], 1e-4, f"solve {n}")
    ja, jm_ = j_damping(a, m, len(je.metas))
    jinv = je._wrap_inv(je._jit_invert(je.state, ja, jm_))
    tinv = te.invert(a, m)
    shapes = tmf.delta_shapes(te.metas)
    eps = [twins["probe"]]
    for n, s in shapes.items():
        for i in (0, int(np.prod(s)) // 2, int(np.prod(s)) - 1):
            e = {k: np.zeros(t, np.float32) for k, t in shapes.items()}
            e[n].reshape(-1)[i] = 1.0
            eps.append(e)
    for e in eps:
        want = je._apply_sqrt(jinv, to_jax(e))
        got = te._apply_sqrt(tinv, to_torch(e))
        for n in want:
            close(got[n], want[n], 1e-4, f"sqrt {n}")


def test_jax_subspace_file_loads_in_the_port(tmp_path):
    """A JAX-written subspace factor file (the CLI's npz layout) read by
    the port through ``models.state_from_jax`` gives JAX's posterior:
    logdet 1e-5 relative, quad 1e-5 relative, a sample from JAX's
    standard-normal draws 1e-4 of max."""
    tm, jm, variables, x, tx = pair("grouped")
    je = jest.Subspace(jm, jv(variables), rank=8)
    je.update(jnp.asarray(x), rng=jax.random.PRNGKey(0))
    path = str(tmp_path / "grouped_subspace.npz")
    jckpt.save_pytree(path, je.state)
    state = tmodels.state_from_jax(tckpt.load_pytree(path), "cpu")
    te = port_est.Subspace(tm, omega={n: v["omega"]
                                      for n, v in state.items()})
    te.state = state
    want = je.logdet_precision(ADD, MULT)
    assert abs(te.logdet_precision(ADD, MULT) - want) <= 1e-5 * abs(want)
    probe = {n: np.ones(s, np.float32)
             for n, s in tmf.delta_shapes(te.metas).items()}
    want = float(je.quadratic_form(to_jax(probe), ADD, MULT))
    got = te.quadratic_form(to_torch(probe), ADD, MULT)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    je.invert(ADD, MULT)
    te.invert(ADD, MULT)
    key = jax.random.PRNGKey(9)
    want = je.sample(key)
    noise = {}
    for n in je.metas:
        key, sub = jax.random.split(key)
        noise[n] = np.asarray(jax.random.normal(
            sub, je.inv_state[f"w::{n}"].shape[1:], jnp.float32))
    got = te.sample(noise=noise)
    for n in want:
        close(got[n], want[n], 1e-4, n)
