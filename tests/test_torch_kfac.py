"""The whole slice against the JAX package on ResNet-18 (CIFAR stem, 32²,
B=2, injected labels): KFAC factors, their damped inverse Choleskys,
logdet, posterior samples with the same standard-normal draws, and the
Bayesian eval with a given ensemble.

The port runs with ``use_kernels=True``, so on the CPU the plain versions
of the patch-Gram kernels run; JAX runs ``use_pallas=False``. At 32²
ResNet-18 reaches every A-factor branch:

  * tiled, stride 1: ``layer1.*`` (16²x64 after the maxpool);
  * tiled, stride 2: ``layer2.0.conv1`` (16²x64);
  * corr: ``layer2.0.conv2`` and ``layer2.1.*`` (8²x128, with
    ``corr_gram_min_extent=8`` in both packages);
  * v2, stride 2: ``layer3.0.conv1`` (8²x128);
  * patches: the stem, the 1x1 downsamples, ``layer3.0.conv2`` /
    ``layer3.1.*`` (4²x256) and ``fc``.

``layer4.*`` is filtered out: its 4608² factors make the CPU inversion
the slowest part of the file and add no branch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.eval import evaluate as jeval
from curvature_tpu.eval import metrics as jmetrics
from curvature_tpu_torch import estimators as torch_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.eval import evaluate as teval
from curvature_tpu_torch.eval import metrics as tmetrics
from curvature_tpu_torch.ops.cuda import patch_gram as tpg

torch.set_num_threads(1)

LAYERS = ["conv1", "layer1.*", "layer2.*", "layer3.*", "fc"]
ADD, MULTIPLY = 1.0, 50.0
BRANCHES = {
    "tiled": ["layer1.0.conv1", "layer1.0.conv2", "layer1.1.conv1",
              "layer1.1.conv2", "layer2.0.conv1"],
    "v2": ["layer3.0.conv1"],
}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, rel, what):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([[3, 7]], np.int32)                  # [S=1, B]
    jm = jmodels.resnet18(num_classes=10)
    tm = tmodels.resnet18(num_classes=10, device="cpu")
    # undamped residual branches: the G factors' backward through
    # batch-statistics BN is best conditioned there (with the default
    # residual_gain=0.2 the f32 rounding of either package reaches 4e-3 of
    # max|G| at layer2.1; the eval tests below use the default weights)
    variables = tmodels.seeded_variables(tm, 0, residual_gain=1.0)
    tmodels.load_jax_variables(tm, variables)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    # records the metas, abstractly (no FLOPs)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    je = jest.KFAC(jm, jv, use_pallas=False, corr_gram_min_extent=8,
                   layer_filter=LAYERS)
    te = torch_est.KFAC(tm, use_kernels=True, corr_gram_min_extent=8,
                    layer_filter=LAYERS)
    assert list(te.metas) == list(je.metas)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    te.update(_nchw(x), labels=torch.from_numpy(labels))
    return dict(x=x, labels=labels, jm=jm, jv=jv, tm=tm, je=je, te=te)


def test_dispatch_reaches_every_branch(pair):
    te = pair["te"]
    acts = torch_est.collect(te.model, te.metas, _nchw(pair["x"]),
                         labels=torch.from_numpy(pair["labels"])).acts
    route = {}
    for name, meta in te.metas.items():
        if meta.kind != "conv":
            route[name] = "dense"
            continue
        act = acts[name]                                      # NHWC
        if te._corr_gram_ok(meta, act):
            route[name] = "corr"
        else:
            route[name] = tpg.select_patch_gram(
                act.shape[-1], meta.kernel_size, meta.strides,
                act.shape[1], act.shape[2], act.shape[0], 4) or "patches"
    for which, names in BRANCHES.items():
        assert [n for n, r in route.items() if r == which] == names
    assert route["layer2.0.conv2"] == "corr"
    assert route["layer2.1.conv1"] == route["layer2.1.conv2"] == "corr"
    assert route["conv1"] == route["layer3.0.conv2"] == "patches"
    assert route["layer2.0.downsample.0"] == "patches"
    assert route["fc"] == "dense"


def test_factors_match_jax(pair):
    """A at 1e-5 of max|A|; G at 1e-4 of max|G| (its backward runs through
    batch-statistics BN, whose f32 rounding the gradients amplify)."""
    je, te = pair["je"], pair["te"]
    for name in je.metas:
        _close(te.state[name]["a"], je.state[name]["a"], 1e-5, f"{name} A")
        _close(te.state[name]["g"], je.state[name]["g"], 1e-4, f"{name} G")


@pytest.fixture(scope="module")
def inverted(pair):
    je, te = pair["je"], pair["te"]
    je.invert(ADD, MULTIPLY)
    te.invert(ADD, MULTIPLY)
    return pair


def test_inverse_choleskys_and_logdet_match_jax(inverted):
    """1e-4 of max: Cholesky factors of the (1e-4-close) G factors."""
    je, te = inverted["je"], inverted["te"]
    for name in je.metas:
        for key in ("a_chol", "g_chol"):
            _close(te.inv_state[name][key], je.inv_state[name][key], 1e-4,
                   f"{name} {key}")
    want = je.logdet_precision(ADD, MULTIPLY)
    got = te.logdet_precision(ADD, MULTIPLY)
    assert abs(got - want) <= 1e-5 * abs(want)


def _jax_noise(je, seed):
    """The per-layer draws of KFAC.sample_state (kfac.py:789, 866):
    ``rng, key = split(rng)`` per layer in meta order, then
    ``normal(key, (cols, out))``."""
    rng = jax.random.PRNGKey(seed)
    noise = {}
    for name, meta in je.metas.items():
        rng, key = jax.random.split(rng)
        noise[name] = np.array(jax.random.normal(
            key, (meta.mat_cols, meta.out_features), jnp.float32))
    return noise


def test_samples_match_jax_with_the_same_draws(inverted):
    """5e-4 of max: a draw multiplies two inverse Cholesky factors, each
    up to 4e-5 of max apart (the inversion amplifies the factors' f32
    rounding by the damped condition number), over contractions of up
    to 1153 terms (measured on the CPU: 1.5e-4 at layer2.0.conv1)."""
    je, te = inverted["je"], inverted["te"]
    want = je.sample(jax.random.PRNGKey(5))
    got = te.sample(noise=_jax_noise(je, 5))
    for name in je.metas:
        _close(got[name], want[name], 5e-4, f"{name} sample")


@pytest.fixture(scope="module")
def eval_pair():
    """ResNet-18 pair with the default seeded weights (damped residual
    branches: an unsaturated eval-mode softmax)."""
    jm = jmodels.resnet18(num_classes=10)
    tm = tmodels.resnet18(num_classes=10, device="cpu")
    variables = tmodels.seeded_variables(tm, 1)
    tmodels.load_jax_variables(tm, variables)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm


def test_eval_bnn_with_given_ensemble_matches_jax(eval_pair):
    """Mean probabilities of a given 3-sample ensemble (the tracked
    weights plus seeded offsets of 5% of each tensor's scale) and the
    metrics, at 1e-5."""
    jm, jv, tm = eval_pair
    rng = np.random.default_rng(9)
    data = [(rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             np.array([1, 4])) for _ in range(2)]
    own = {k: v.detach() for k, v in tm.named_parameters()
           if k.rsplit(".", 1)[0] in tm.metas}
    t_ens = [{k: v + 0.05 * v.std() * torch.from_numpy(
                  rng.standard_normal(tuple(v.shape)).astype(np.float32))
              for k, v in own.items()} for _ in range(3)]
    j_params = []
    for params in t_ens:
        p = jax.tree_util.tree_map(np.asarray, jv["params"])
        for key, val in params.items():
            layer, leaf = key.rsplit(".", 1)
            w = val.numpy()
            if leaf == "weight":
                leaf, w = "kernel", (w.transpose(2, 3, 1, 0) if w.ndim == 4
                                     else w.T)
            p[layer] = dict(p[layer], **{leaf: w})
        j_params.append(p)
    j_ens = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *j_params)
    want, labels, _ = jeval.eval_bnn(jm, jv, None, data, samples=3,
                                     ensemble_params=j_ens)
    got, t_labels, _ = teval.eval_bnn(
        tm, None, [(_nchw(x), y) for x, y in data], samples=3,
        ensemble_params=t_ens)
    np.testing.assert_array_equal(t_labels, labels)
    assert want.max() < 0.99                # an unsaturated softmax
    _close(got, want, 1e-5, "bnn mean probabilities")
    for fn in ("accuracy", "negative_log_likelihood"):
        w = float(getattr(jmetrics, fn)(want, labels))
        g = float(getattr(tmetrics, fn)(got, t_labels))
        assert abs(g - w) <= 1e-5 * max(abs(w), 1.0), fn
    w = float(jmetrics.expected_calibration_error(want, labels)[0])
    g = float(tmetrics.expected_calibration_error(got, t_labels)[0])
    assert abs(g - w) <= 1e-5
    w = np.asarray(jmetrics.predictive_entropy(want))
    g = tmetrics.predictive_entropy(got).numpy()
    np.testing.assert_allclose(g, w, atol=1e-5)


def test_eval_bnn_given_ensemble_sets_the_count(eval_pair):
    """A given ensemble's mean is over its own members: ``samples`` only
    sizes an ensemble that ``eval_bnn`` draws itself."""
    _, _, tm = eval_pair
    rng = np.random.default_rng(10)
    data = [(_nchw(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
             np.array([1, 4]))]
    own = {k: v.detach() for k, v in tm.named_parameters()
           if k.rsplit(".", 1)[0] in tm.metas}
    ens = [{k: v + 0.05 * v.std() * torch.from_numpy(
                rng.standard_normal(tuple(v.shape)).astype(np.float32))
            for k, v in own.items()} for _ in range(3)]
    three, _, stats = teval.eval_bnn(tm, None, data, samples=3,
                                     ensemble_params=ens, stats=True)
    thirty, _, stats30 = teval.eval_bnn(tm, None, data, samples=30,
                                        ensemble_params=ens, stats=True)
    np.testing.assert_array_equal(thirty, three)
    np.testing.assert_allclose(three.sum(1), 1.0, atol=1e-5)
    assert stats30 == stats and len(stats["acc"]) == 3


def test_eval_nn_matches_jax(eval_pair):
    jm, jv, tm = eval_pair
    x = np.random.default_rng(11).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want, _ = jeval.eval_nn(jm, jv, [(x, np.array([0, 1]))])
    got, _ = teval.eval_nn(tm, [(_nchw(x), np.array([0, 1]))])
    _close(got, want, 1e-5, "nn probabilities")
