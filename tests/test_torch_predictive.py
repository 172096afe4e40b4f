"""The closed-form and linearized predictives, temperature scaling,
``BayesianPredictor`` and the ``laplace`` facade of the port against the
JAX package.

LeNet-5 with the bundled weights on the bundled digits, and a ResNet-18
(CIFAR stem, 32², seeded weights and BN statistics, ``conv1``,
``layer1.*`` and ``fc`` tracked) on numpy-seeded images. JAX's KFAC
factors (two updates with injected labels) and JAX's inverse are fed to
the port (``models.state_from_jax``), and the posterior draws are JAX's:
its key schedule rebuilt into the standard-normal ``noise`` of the port's
``ensemble_params``. Tolerances are relative to the max of the JAX value.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import laplace as jlaplace
from curvature_tpu import models as jmodels
from curvature_tpu.eval import calibrate as jcal
from curvature_tpu.eval import predictive as jpred
from curvature_tpu.eval import predictor as jpredictor
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import laplace as tlaplace
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.eval import calibrate as tcal
from curvature_tpu_torch.eval import evaluate as teval
from curvature_tpu_torch.eval import predictive as tpred
from curvature_tpu_torch.eval import predictor as tpredictor
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

ARGV = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
        "--data_dir", tloaders.FIXTURE_DIR, "--batch_size", "64"]
NORM, SCALE, SAMPLES = 1.0, 5e4, 4
R18_LAYERS = ["conv1", "layer1.*", "fc"]
R18_DAMPING = (1e2, 1e2)
#: probabilities, of max: LeNet-5's sampled logits at (1, 5e4) reach
#: |158|, where the two packages' f32 forwards differ by up to 2.5e-4
#: (1.6e-6 of max, measured on the CPU), up to 7.4e-6 in a probability;
#: ResNet-18's stay within 1e-5
RTOL = {"lenet": 5e-5, "r18": 1e-5}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _jax_noise(t, seed, samples):
    """The standard-normal draws of JAX's ``ensemble_params(PRNGKey(seed),
    samples)``: one key per sample, then one per layer in meta order, at
    the port's noise shapes (JAX's)."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(seed), samples):
        noise = {}
        for name, shape in t.noise_shapes().items():
            key, k = jax.random.split(key)
            noise[name] = np.array(jax.random.normal(k, shape, jnp.float32))
        out.append(noise)
    return out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _fed_kfac(jm, jv, tm, batches, damping, **kw):
    """JAX KFAC updated on ``batches`` with seeded labels and inverted at
    ``damping``; the port's KFAC holding JAX's state and inverse."""
    je = jest.KFAC(jm, jv, use_pallas=False, **kw)
    rng = np.random.default_rng(0)
    for x, _ in batches:
        labels = rng.integers(0, 10, (1, x.shape[0])).astype(np.int32)
        je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    je.invert(*damping)
    te = port_est.KFAC(tm, **kw)
    te.state = tmodels.state_from_jax(je.state, "cpu")
    te.inv_state = tmodels.state_from_jax(je.inv_state, "cpu")
    return je, te


@pytest.fixture(scope="module")
def lenet():
    t, j = tconfig.parse_args(ARGV), jconfig.parse_args(ARGV)
    tm = tcommon.build_model(t)
    jm, jv = jcommon.build_model(j)
    train = list(tcommon.build_data(t, splits="train"))[:2]
    val = list(tcommon.build_data(t, splits="val"))[:2]
    test = list(tcommon.build_data(t, splits="test"))[:2]
    je, te = _fed_kfac(jm, jv, tm, train, (NORM, SCALE))
    noise = _jax_noise(te, 5, SAMPLES)
    return dict(tm=tm, jm=jm, jv=jv, je=je, te=te, train=train, val=val,
                test=test, noise=noise,
                ens=te.ensemble_params(SAMPLES, noise=noise),
                nchw=[(_nchw(x), y) for x, y in test])


@pytest.fixture(scope="module")
def r18():
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
                np.array([3, 7])) for _ in range(2)]
    jm = jmodels.resnet18(num_classes=10)
    tm = tmodels.resnet18(num_classes=10, device="cpu")
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.asarray(batches[0][0])))
    je, te = _fed_kfac(jm, jv, tm, batches, R18_DAMPING,
                       layer_filter=R18_LAYERS)
    noise = _jax_noise(te, 5, SAMPLES)
    return dict(tm=tm, jm=jm, jv=jv, je=je, te=te, data=batches,
                noise=noise, ens=te.ensemble_params(SAMPLES, noise=noise),
                nchw=[(_nchw(x), y) for x, y in batches])


# -- the closed forms ---------------------------------------------------------

@pytest.mark.parametrize("k", [2, 10, 1000])
def test_probit_and_bridge_match_jax(k):
    """Element-wise against JAX, 1e-6 of max (the bridge's alpha in log
    space), at random moments, at zero variance (the bridge's near-one-hot
    limit, through its log-space mean) and at large logits."""
    rng = np.random.default_rng(k)
    mu = (3.0 * rng.standard_normal((64, k))).astype(np.float32)
    var = rng.exponential(2.0, (64, k)).astype(np.float32)
    var[:8] = 0.0                                   # zero variance rows
    mu[8:16] *= 50.0                                # large logits
    tm_, tv = torch.from_numpy(mu), torch.from_numpy(var)
    _close(tpred.probit_mean_field(tm_, tv),
           jpred.probit_mean_field(jnp.asarray(mu), jnp.asarray(var)),
           1e-6, "probit")
    alpha_j, mean_j = jpred.laplace_bridge(jnp.asarray(mu), jnp.asarray(var))
    alpha_t, mean_t = tpred.laplace_bridge(tm_, tv)
    _close(mean_t, mean_j, 1e-6, "bridge mean")
    fin = np.isfinite(np.asarray(alpha_j))
    assert np.array_equal(np.isfinite(_np(alpha_t)), fin)
    # alpha = exp(log alpha) spans 1e-2..1e38: compared in log space
    _close(np.log(_np(alpha_t)[fin]), np.log(np.asarray(alpha_j)[fin]),
           1e-6, "bridge log alpha")
    assert np.isfinite(_np(mean_t)).all()
    # zero variance: argmax kept, sharpened toward one-hot
    top = _np(mean_t)[:8].argmax(1)
    assert np.array_equal(top, mu[:8].argmax(1))


@pytest.mark.parametrize("method", ["probit", "bridge"])
@pytest.mark.parametrize("net", ["lenet", "r18"])
def test_closed_form_predictive_matches_jax(request, net, method):
    """``eval_bnn_closed_form`` with JAX's draws and inverse, ``RTOL`` of
    max (LeNet-5 on 128 digits; ResNet-18 in eval mode, its BN on the
    running statistics)."""
    f = request.getfixturevalue(net)
    data = f["test"] if net == "lenet" else f["data"]
    want, wl = jpred.eval_bnn_closed_form(f["jm"], f["jv"], f["je"], data,
                                          SAMPLES, jax.random.PRNGKey(5),
                                          method)
    got, gl = tpred.eval_bnn_closed_form(f["tm"], f["te"], f["nchw"],
                                         SAMPLES, ensemble_params=f["ens"],
                                         method=method)
    np.testing.assert_array_equal(gl, wl)
    _close(got, want, RTOL[net], method)


@pytest.mark.parametrize("method", ["mc", "probit", "bridge"])
@pytest.mark.parametrize("net", ["lenet", "r18"])
def test_linearized_predictive_matches_jax(request, net, method):
    """``eval_bnn_linearized`` (``torch.func.jvp`` of ``functional_call``
    against ``jax.linearize``) with JAX's draws and inverse, ``RTOL`` of
    max."""
    f = request.getfixturevalue(net)
    data = f["test"] if net == "lenet" else f["data"]
    want, _ = jpred.eval_bnn_linearized(f["jm"], f["jv"], f["je"], data,
                                        SAMPLES, jax.random.PRNGKey(5),
                                        method)
    got, _ = tpred.eval_bnn_linearized(f["tm"], f["te"], f["nchw"], SAMPLES,
                                       ensemble_params=f["ens"],
                                       method=method)
    _close(got, want, RTOL[net], method)


def _bn_in_input_dtype(self, x, ctx=None):
    """Eval-mode BatchNorm in the input's dtype (the port's layer computes
    in f32)."""
    return torch.nn.functional.batch_norm(
        x, self.running_mean, self.running_var, self.weight, self.bias,
        training=False, eps=self.eps)


@pytest.mark.parametrize("net", ["lenet", "r18"])
def test_linearized_logits_are_the_directional_derivative(request, net,
                                                          monkeypatch):
    """In float64 (BatchNorm too), J(x)(theta_s - theta*) of the
    linearized forward against a central finite difference of the
    network along the same offset, step 1e-7: 1e-6 of max (through
    BatchNorm in eval mode and the Sequential/Add containers)."""
    monkeypatch.setattr(tnn.BatchNorm, "forward", _bn_in_input_dtype)
    f = request.getfixturevalue(net)
    tm = copy.deepcopy(f["tm"]).double()
    mean = {k: v.double() for k, v in f["te"].mean_params.items()}
    ens = [{k: v.double() for k, v in e.items()} for e in f["ens"][:2]]
    x = f["nchw"][0][0].double()
    logits0, logits_s = tpred.make_linearized_ensemble_fn(tm)(mean, ens, x)
    eps = 1e-7
    for e, lin in zip(ens, logits_s):
        plus = {k: mean[k] + eps * (e[k] - mean[k]) for k in mean}
        minus = {k: mean[k] - eps * (e[k] - mean[k]) for k in mean}
        fd = (tpred.make_logit_ensemble_fn(tm)([plus, minus], x))
        _close(lin - logits0, (fd[0] - fd[1]) / (2 * eps), 1e-6, "jvp")


def test_linearized_is_exact_for_a_linear_model(lenet):
    """Logits linear in the parameters: the linearized ensemble is the
    sampled one (to f32 rounding, 1e-5 of max), so GLM and MC predictives
    and the predictor's two paths agree."""
    model = tnn.Sequential([tnn.Flatten(), tnn.Dense(784, 10, name="fc")])
    est = port_est.KFAC(model)
    xs = [x for x, _ in lenet["nchw"]]
    gen = torch.Generator().manual_seed(0)
    for x in xs:
        est.update(x, generator=gen)
    est.invert(1.0, 10.0)
    ens = est.ensemble_params(SAMPLES, generator=gen)
    logits0, lin = tpred.make_linearized_ensemble_fn(model)(
        est.mean_params, ens, xs[0])
    sampled = tpred.make_logit_ensemble_fn(model)(ens, xs[0])
    _close(lin, sampled, 1e-5, "linearized logits")
    _close(logits0, model(xs[0]).detach(), 1e-6, "MAP logits")
    mc, _ = tpred.eval_bnn_linearized(model, est, lenet["nchw"], SAMPLES,
                                      ensemble_params=ens, method="mc")
    want, _, _ = teval.eval_bnn(model, est, lenet["nchw"], SAMPLES,
                                ensemble_params=ens)
    _close(mc, want, 1e-5, "GLM vs MC predictive")
    pred = tpredictor.BayesianPredictor(model, est, ensemble_params=ens)
    for a, b in zip(pred.predict_linearized(xs[0]), pred(xs[0])):
        _close(a, b, 1e-5, "predictor")


@pytest.mark.parametrize("linearized", [True, False])
def test_regression_predictive_matches_jax(lenet, linearized):
    """``eval_bnn_regression`` on LeNet-5's ten outputs as a regression
    head (targets one-hot): means and variances 1e-5 of max."""
    data_j = [(x, np.eye(10, dtype=np.float32)[y]) for x, y in lenet["test"]]
    data_t = [(xt, yt) for (xt, _), (_, yt) in zip(lenet["nchw"], data_j)]
    want = jpred.eval_bnn_regression(lenet["jm"], lenet["jv"], lenet["je"],
                                     data_j, SAMPLES, jax.random.PRNGKey(5),
                                     linearized=linearized, noise_var=0.5)
    got = tpred.eval_bnn_regression(lenet["tm"], lenet["te"], data_t,
                                    SAMPLES, ensemble_params=lenet["ens"],
                                    linearized=linearized, noise_var=0.5)
    for g, w, what in zip(got, want, ("mean", "var", "targets")):
        _close(g, w, 1e-5, what)


def test_methods_are_checked(lenet):
    with pytest.raises(ValueError, match="closed-form"):
        tpred.eval_bnn_closed_form(lenet["tm"], lenet["te"], lenet["nchw"],
                                   ensemble_params=lenet["ens"],
                                   method="mc")
    with pytest.raises(ValueError, match="linearized"):
        tpred.eval_bnn_linearized(lenet["tm"], lenet["te"], lenet["nchw"],
                                  ensemble_params=lenet["ens"],
                                  method="sampled")


# -- temperature scaling ------------------------------------------------------

def test_temperature_matches_jax(lenet):
    """Logits 1e-5 of max; T after JAX's 200 Adam steps (optax against
    ``torch.optim.Adam``) within 1e-4; the scaled test probabilities 1e-4
    of max; the validation NLL at T no worse than at T = 1."""
    jl, jy = jcal.collect_logits(lenet["jm"], lenet["jv"], lenet["val"])
    val = [(_nchw(x), y) for x, y in lenet["val"]]
    tl, ty = tcal.collect_logits(lenet["tm"], val)
    np.testing.assert_array_equal(ty, jy)
    _close(tl, jl, 1e-5, "logits")
    t_j = jcal.fit_temperature(jl, jy)
    t_t = tcal.fit_temperature(tl, ty)
    assert abs(t_t - t_j) <= 1e-4 * t_j, (t_t, t_j)
    want, wl, _ = jcal.eval_nn_temperature(lenet["jm"], lenet["jv"],
                                           lenet["val"], lenet["test"])
    got, gl, t = tcal.eval_nn_temperature(lenet["tm"], val, lenet["nchw"])
    np.testing.assert_array_equal(gl, wl)
    _close(got, want, 1e-4, "scaled probabilities")

    def nll(temp):
        p = tcal.temperature_scale(tl, temp)
        return -np.mean(np.log(p[np.arange(len(ty)), ty]))
    assert np.isfinite(t) and nll(t) <= nll(1.0)


# -- BayesianPredictor --------------------------------------------------------

@pytest.mark.parametrize("net", ["lenet", "r18"])
def test_predictor_matches_jax(request, net):
    """Sampled, closed-form (probit, bridge) and linearized predictions:
    every field of ``Prediction`` within ``RTOL`` of max against JAX's
    ``BayesianPredictor`` with the same draws (the epistemic part, a
    difference of entropies, of the total entropy's max)."""
    f = request.getfixturevalue(net)
    x = (f["test"] if net == "lenet" else f["data"])[0][0]
    jp = jpredictor.BayesianPredictor(f["jm"], f["jv"], f["je"], SAMPLES,
                                      rng=jax.random.PRNGKey(5))
    tp = tpredictor.BayesianPredictor(f["tm"], f["te"],
                                      ensemble_params=f["ens"])
    xt = _nchw(x)
    pairs = [(jp(jnp.asarray(x)), tp(xt))]
    for m in ("probit", "bridge"):
        pairs.append((jp.predict_closed_form(jnp.asarray(x), m),
                      tp.predict_closed_form(xt, m)))
    pairs.append((jp.predict_linearized(jnp.asarray(x)),
                  tp.predict_linearized(xt)))
    for want, got in pairs:
        for field in ("mean", "entropy", "aleatoric"):
            _close(getattr(got, field), getattr(want, field), RTOL[net],
                   field)
        np.testing.assert_allclose(
            _np(got.epistemic), np.asarray(want.epistemic),
            atol=RTOL[net] * float(np.abs(want.entropy).max()))
    with pytest.raises(ValueError, match="closed-form"):
        tp.predict_closed_form(xt, "mc")


def test_predictor_bf16_is_close_to_f32(r18):
    """``compute_dtype=bfloat16`` forwards (softmax and entropies in f32)
    on ResNet-18: the mean probabilities of the sampled and the
    linearized predictive within 0.05 of the f32 ones, JAX's bar for its
    bf16 predictor (tests/test_eval.py:164)."""
    x = r18["nchw"][0][0]
    f32 = tpredictor.BayesianPredictor(r18["tm"], r18["te"],
                                       ensemble_params=r18["ens"])
    b16 = tpredictor.BayesianPredictor(r18["tm"], r18["te"],
                                       ensemble_params=r18["ens"],
                                       compute_dtype=torch.bfloat16)
    for a, b in ((f32(x), b16(x)),
                 (f32.predict_linearized(x), b16.predict_linearized(x))):
        assert b.mean.dtype == torch.float32
        np.testing.assert_allclose(_np(b.mean), _np(a.mean), atol=0.05)
        np.testing.assert_allclose(_np(b.mean.sum(1)), 1.0, rtol=1e-5)


def test_bf16_eval_of_a_batchnorm_model(r18):
    """``eval_nn`` and ``eval_bnn`` with ``compute_dtype=bfloat16`` on
    ResNet-18 (BatchNorm's running statistics stay f32, as JAX keeps
    ``batch_stats``): f32 probabilities within 0.05 of the f32 eval, JAX's
    bar (tests/test_eval.py:167-181)."""
    f32, _ = teval.eval_nn(r18["tm"], r18["nchw"])
    b16, _ = teval.eval_nn(r18["tm"], r18["nchw"],
                           compute_dtype=torch.bfloat16)
    assert b16.dtype == np.float32
    np.testing.assert_allclose(b16, f32, atol=0.05)
    m32, _, _ = teval.eval_bnn(r18["tm"], r18["te"], r18["nchw"], SAMPLES,
                               ensemble_params=r18["ens"])
    m16, _, _ = teval.eval_bnn(r18["tm"], r18["te"], r18["nchw"], SAMPLES,
                               ensemble_params=r18["ens"],
                               compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(m16, m32, atol=0.05)


# -- the laplace facade -------------------------------------------------------

def test_facade_matches_jax(lenet):
    """``Laplace`` over JAX's factors: the MAP NLL 1e-5, the evidence
    tuning's trace and damping 1e-4 (relative), the evidence at the tuned
    damping 1e-5, and every predictive method within ``RTOL`` of max with
    JAX's draws after the tuned inversion."""
    je = jest.KFAC(lenet["jm"], lenet["jv"], use_pallas=False)
    je.state = lenet["je"].state             # the facade inverts its own
    jla = jlaplace.Laplace(lenet["jm"], lenet["jv"], je, lenet["train"])
    train = [(_nchw(x), y) for x, y in lenet["train"]]
    te = port_est.KFAC(lenet["tm"])
    te.state = lenet["te"].state
    tla = tlaplace.Laplace(lenet["tm"], te, train)
    assert abs(tla.map_nll() - jla.map_nll()) <= 1e-5 * jla.map_nll()
    with pytest.raises(ValueError, match="invert first"):
        tla.predictive(train[0][0])
    want = jla.optimize_prior_precision(steps=30)
    got = tla.optimize_prior_precision(steps=30)
    _close(got["trace"], want["trace"], 1e-4, "trace")
    for k in ("norms", "scales"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    assert abs(tla.log_marginal_likelihood()
               - jla.log_marginal_likelihood()) \
        <= 1e-5 * abs(jla.log_marginal_likelihood())
    # the port's inverse replaced by JAX's at the tuned damping, so the
    # predictives differ only by the forwards
    te.inv_state = tmodels.state_from_jax(je.inv_state, "cpu")
    x = lenet["test"][0][0]
    noise = _jax_noise(te, 5, SAMPLES)
    for method in tlaplace.METHODS:
        w = jla.predictive(jnp.asarray(x), method, SAMPLES,
                           jax.random.PRNGKey(5))
        g = tla.predictive(_nchw(x), method, SAMPLES, noise=noise)
        _close(g, w, RTOL["lenet"], method)
    with pytest.raises(ValueError, match="unknown predictive"):
        tla.predictive(_nchw(x), "mc")


@pytest.mark.parametrize("kind", ["diag", "kfac", "block", "efb", "inf"])
def test_facade_fit_every_estimator(lenet, kind):
    """``laplace.fit`` builds each estimator (EFB and INF their
    prerequisites first; Block on the last layer), inverts it at its tuned
    damping and predicts finite probabilities summing to 1; the ensemble
    is drawn once per damping and reused."""
    train = [(_nchw(x), y) for x, y in lenet["train"][:1]]
    kw = {"subset": "last"} if kind == "block" else {"rank": 20} \
        if kind == "inf" else {}
    la = tlaplace.fit(lenet["tm"], train, kind, mc_samples=1, **kw)
    la.optimize_prior_precision(steps=5)
    x = train[0][0][:8]
    for method in ("sampled", "linearized_probit"):
        p = la(x, method=method, samples=2)
        assert p.shape == (8, 10) and np.isfinite(p).all()
        np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-5)
    ens = la._ens_cache["ens"]
    la(x, samples=2)
    assert la._ens_cache["ens"] is ens


def test_facade_parts_out_of_this_slice_raise(lenet):
    train = [(_nchw(x), y) for x, y in lenet["train"][:1]]
    # the low-rank Laplace is ported (tests/test_torch_subspace.py)
    for name in ("subspace", "lowrank"):
        la = tlaplace.fit(lenet["tm"], train, name, rank=4)
        assert type(la.estimator).__name__ == "Subspace"
        assert la.estimator.rank == 4
    with pytest.raises(ValueError, match="unknown estimator"):
        tlaplace.fit(lenet["tm"], train, "swag-ish")
    la = tlaplace.Laplace(lenet["tm"], lenet["te"])
    with pytest.raises(ValueError, match="marglik"):
        la.optimize_prior_precision(method="cv")
    with pytest.raises(ValueError, match="train_data"):
        la.map_nll()
