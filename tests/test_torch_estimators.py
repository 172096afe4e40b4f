"""The rest of the estimator ladder (Diagonal, BlockDiagonal, EFB, INF) and
the Gaussian API of all five estimators against the JAX package, on the
ResNet-18 pair of tests/test_torch_kfac.py (CIFAR stem, 32², B=2, injected
labels, undamped residual branches, ``layer4.*`` filtered out).

Each stage is held against JAX given the same inputs: the estimators'
states are compared after one update from the same batch; EFB and INF are
then built from JAX's KFAC factors (and EFB's lambdas, diags and
eigenvectors: ``torch.linalg.eigh`` and ``jnp.linalg.eigh`` agree on
eigenvalues, not on the eigenvectors of near-degenerate eigenspaces, and
the lambdas depend on the basis); the inverse states, samples (the same
standard-normal draws, JAX's key schedule rebuilt), logdet, quadratic form
and solve are compared with JAX's state fed to the port.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.estimators import capture as jcapture
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels

torch.set_num_threads(1)

LAYERS = ["conv1", "layer1.*", "layer2.*", "layer3.*", "fc"]
BLOCK_LAYERS = ["conv1", "fc"]
ADD, MULTIPLY = 1.0, 50.0
#: INF rank: rank 100 makes R x R Grams of up to 104^2 = 10,816 per layer,
#: too slow for a CPU test; 20 keeps every layer's selection non-trivial
RANK = 20
KINDS = ("kfac", "diag", "block", "efb", "inf")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _to_port(state):
    return tmodels.state_from_jax(state, "cpu")


@pytest.fixture(scope="module")
def ladder():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([[3, 7]], np.int32)                  # [S=1, B]
    jm = jmodels.resnet18(num_classes=10)
    tm = tmodels.resnet18(num_classes=10, device="cpu")
    variables = tmodels.seeded_variables(tm, 0, residual_gain=1.0)
    tmodels.load_jax_variables(tm, variables)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jx, jl = jnp.asarray(x), jnp.asarray(labels)
    tx, tl = _nchw(x), torch.from_numpy(labels)

    j, t = {}, {}
    j["kfac"] = jest.KFAC(jm, jv, use_pallas=False, layer_filter=LAYERS)
    j["kfac"].update(jx, labels=jl)
    for kind, cls, kw in (("diag", "Diagonal", {"layer_filter": LAYERS}),
                          ("block", "BlockDiagonal",
                           {"layer_filter": BLOCK_LAYERS})):
        j[kind] = getattr(jest, cls)(jm, jv, **kw)
        t[kind] = getattr(port_est, cls)(tm, **kw)
        j[kind].update(jx, labels=jl)
        t[kind].update(tx, labels=tl)
    kfac_state = _to_port(j["kfac"].state)
    j["efb"] = jest.EFB(jm, jv, j["kfac"].state, layer_filter=LAYERS)
    j["efb"].update(jx, labels=jl)
    t["efb"] = port_est.EFB(tm, kfac_state, layer_filter=LAYERS)
    # eigh picks its basis freely inside degenerate eigenspaces: use JAX's
    t["efb"].eigvecs = _to_port(j["efb"].eigvecs)
    t["efb"].update(tx, labels=tl)
    j["inf"] = jest.INF(jm, jv, j["efb"].diags, j["kfac"].state,
                        j["efb"].state, eigvecs=j["efb"].eigvecs,
                        layer_filter=LAYERS)
    j["inf"].update(rank=RANK)
    t["inf"] = port_est.INF(tm, _to_port(j["efb"].diags), kfac_state,
                            _to_port(j["efb"].state),
                            eigvecs=_to_port(j["efb"].eigvecs),
                            layer_filter=LAYERS)
    t["inf"].update(rank=RANK)
    # the Gaussian API with JAX's state fed to the port
    fed = {"kfac": port_est.KFAC(tm, layer_filter=LAYERS)}
    fed["kfac"].state = kfac_state
    for kind in ("diag", "block"):
        fed[kind] = type(t[kind])(tm, layer_filter=list(j[kind].metas))
        fed[kind].state = _to_port(j[kind].state)
    fed["efb"] = port_est.EFB(tm, kfac_state, layer_filter=LAYERS)
    fed["efb"].eigvecs = _to_port(j["efb"].eigvecs)
    fed["efb"].state = _to_port(j["efb"].state)
    fed["inf"] = t["inf"]
    for kind in KINDS:
        assert list(fed[kind].metas) == list(j[kind].metas), kind
        j[kind].invert(ADD, MULTIPLY)
        fed[kind].invert(ADD, MULTIPLY)
    return dict(x=x, labels=labels, jm=jm, jv=jv, tm=tm, j=j, t=t, fed=fed)


def test_diagonal_state_matches_jax(ladder):
    """1e-4 of max: the parameter gradients run back through
    batch-statistics BN, as KFAC's G factors do."""
    j, t = ladder["j"]["diag"], ladder["t"]["diag"]
    assert list(t.metas) == list(j.metas)
    for name in j.metas:
        _close(t.state[name], j.state[name], 1e-4, name)


def test_block_state_matches_jax(ladder):
    """conv1 (1,728 parameters) and fc (5,130): the flattened gradient's
    outer product in torch ``view(-1)`` order, 1e-4 of max."""
    j, t = ladder["j"]["block"], ladder["t"]["block"]
    assert list(t.metas) == BLOCK_LAYERS
    for name in j.metas:
        _close(t.state[name], j.state[name], 1e-4, name)


def test_efb_lambdas_and_diags_match_jax(ladder):
    """JAX's eigenvectors injected: the eigenbasis moments and the free
    diagonal at 1e-4 of max."""
    j, t = ladder["j"]["efb"], ladder["t"]["efb"]
    for name in j.metas:
        _close(t.state[name], j.state[name], 1e-4, f"{name} lambdas")
        _close(t.diags[name], j.diags[name], 1e-4, f"{name} diags")


def test_inf_index_sets_and_state_match_jax(ladder):
    """With JAX's diags, factors, lambdas and eigenvectors: the selected
    index sets equal (so the gathered eigenvector columns and lambdas are
    bit-equal), the diagonal correction within 1e-5 of max."""
    j, t = ladder["j"]["inf"], ladder["t"]["inf"]
    for name, meta in j.metas.items():
        lam = np.asarray(j.lambdas[name]).T.reshape(-1)
        n, m = meta.mat_cols, meta.out_features
        for got, want in zip(t._select(lam, n, m, RANK, 0),
                             j._select(lam, n, m, RANK, 0)):
            np.testing.assert_array_equal(np.sort(got), np.sort(want))
        js, ts = j.state[name], t.state[name]
        for key in ("ua", "ug", "lam"):
            np.testing.assert_array_equal(_np(ts[key]), np.asarray(js[key]),
                                          err_msg=f"{name} {key}")
        _close(ts["corr"], js["corr"], 1e-5, f"{name} corr")


@pytest.mark.parametrize("kind", ["diag", "block", "efb", "inf"])
def test_inverse_state_matches_jax(ladder, kind):
    """1e-4 of max: the elementwise inverses, Block's inverse Cholesky,
    and INF's Woodbury cache ``pre`` (an analytic matrix function of the
    R x R Gram: unique, whichever eigenvectors each eigh picks)."""
    j, t = ladder["j"][kind], ladder["fed"][kind]
    for name in j.metas:
        if kind == "efb":
            want, got = j.inv_state["ilam"][name], t.inv_state["ilam"][name]
        elif kind == "inf":
            for key in ("inv_corr", "pre"):
                _close(t.inv_state[name][key], j.inv_state[name][key], 1e-4,
                       f"{name} {key}")
            continue
        else:
            want, got = j.inv_state[name], t.inv_state[name]
        _close(got, want, 1e-4, name)


def _jax_noise(j, t, seed):
    """JAX's draws: one key per layer split off in meta order (INF splits
    them all first, the others as they go: the same keys), then
    ``normal(key, shape)`` at the port's noise shape, which is JAX's."""
    rng = jax.random.PRNGKey(seed)
    noise = {}
    for name, shape in t.noise_shapes().items():
        rng, key = jax.random.split(rng)
        noise[name] = np.array(jax.random.normal(key, shape, jnp.float32))
    assert list(noise) == list(j.metas)
    return noise


@pytest.mark.parametrize("kind", KINDS)
def test_samples_match_jax_with_the_same_draws(ladder, kind):
    """5e-4 of max (tests/test_torch_kfac.py's bar for KFAC's draws: the
    inverse factors' f32 rounding over contractions of ~1,000 terms)."""
    j, t = ladder["j"][kind], ladder["fed"][kind]
    want = j.sample(jax.random.PRNGKey(5))
    got = t.sample(noise=_jax_noise(j, t, 5))
    for name in j.metas:
        _close(got[name], want[name], 5e-4, f"{name} sample")


@pytest.mark.parametrize("kind", KINDS)
def test_logdet_matches_jax(ladder, kind):
    j, t = ladder["j"][kind], ladder["fed"][kind]
    want = j.logdet_precision(ADD, MULTIPLY)
    got = t.logdet_precision(ADD, MULTIPLY)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _deltas(j, seed):
    rng = np.random.default_rng(seed)
    return {name: (0.01 * rng.standard_normal(
        (m.out_features, m.mat_cols))).astype(np.float32)
        for name, m in j.metas.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_quadratic_form_matches_jax(ladder, kind):
    j, t = ladder["j"][kind], ladder["fed"][kind]
    d = _deltas(j, 6)
    want = j.quadratic_form({k: jnp.asarray(v) for k, v in d.items()},
                            ADD, MULTIPLY)
    got = t.quadratic_form(d, ADD, MULTIPLY)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_precision_solve_matches_jax(ladder, kind):
    """1e-4 of max per layer, at damping (1, 1): an f32 solve through
    inverse Choleskys is off by ~cond * 2^-24 in either package, and at
    multiply 50 the damped A factors' condition numbers reach 9,300, where
    JAX's own KFAC solve is 1.4e-4 of max from the float64 one (the port's
    6.5e-5, measured on the CPU); at (1, 1) they stay under 1,400."""
    j, t = ladder["j"][kind], ladder["fed"][kind]
    d = _deltas(j, 7)
    want = j.precision_solve({k: jnp.asarray(v) for k, v in d.items()},
                             1.0, 1.0)
    got = t.precision_solve(d, 1.0, 1.0)
    for name in j.metas:
        _close(got[name], want[name], 1e-4, f"{name} solve")


def test_log_density_is_the_gaussian_of_quad_and_logdet(ladder):
    """log N(theta; theta*, P^-1) = -(q + d log 2pi)/2 + logdet/2, with q
    and logdet from JAX on the same offsets."""
    j, t = ladder["j"]["diag"], ladder["fed"]["diag"]
    d = _deltas(j, 8)
    params = dict(t.mean_params)
    for name, meta in t.metas.items():
        w = torch.from_numpy(d[name])
        if meta.has_bias:
            params[f"{name}.bias"] = params[f"{name}.bias"] + w[:, -1]
            w = w[:, :-1]
        key = f"{name}.weight"
        params[key] = params[key] + w.reshape(params[key].shape)
    q = j.quadratic_form({k: jnp.asarray(v) for k, v in d.items()},
                         ADD, MULTIPLY)
    logdet = j.logdet_precision(ADD, MULTIPLY)
    dim = sum(v.size for v in d.values())
    want = -0.5 * (q + dim * math.log(2 * math.pi)) + 0.5 * logdet
    got = t.log_density(params, ADD, MULTIPLY)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_param_grads_match_jax(ladder):
    """Captured.param_grads ([S, out, cols] matrix views) against JAX's
    ``collect`` with two MC label rows, 1e-4 of max (the BN backward)."""
    labels = np.array([[3, 7], [1, 1]], np.int32)
    metas = ladder["t"]["diag"].metas
    want = jcapture.collect(ladder["jm"], ladder["j"]["diag"].metas,
                            ladder["jv"], jnp.asarray(ladder["x"]),
                            labels=jnp.asarray(labels),
                            need_probe_grads=False).param_grads
    cap = port_est.collect(ladder["tm"], metas, _nchw(ladder["x"]),
                           labels=torch.from_numpy(labels),
                           need_probe_grads=False)
    assert cap.probe_grads == {}
    for name in metas:
        _close(cap.param_grads[name], want[name], 1e-4, name)


def test_kfac_collect_computes_no_param_grads(ladder):
    """KFAC consumes the probes alone: its capture returns no parameter
    gradients, and autograd never computes one (no hook on a tracked
    weight fires)."""
    tm = ladder["tm"]
    est = port_est.KFAC(tm, layer_filter=LAYERS)
    assert not est.need_param_grads and est.need_probe_grads
    fired = []
    hooks = [p.register_hook(lambda g, k=k: fired.append(k))
             for k, p in tm.named_parameters()]
    try:
        cap = est.capture(_nchw(ladder["x"]),
                          torch.from_numpy(ladder["labels"]))
    finally:
        for h in hooks:
            h.remove()
    assert cap.param_grads == {} and set(cap.probe_grads) == set(est.metas)
    assert fired == []
    assert all(p.grad is None for p in tm.parameters())


def test_gradient_estimators_take_no_probe_grads(ladder):
    for kind in ("diag", "block", "efb"):
        est = ladder["t"][kind]
        assert est.need_param_grads and not est.need_probe_grads
        cap = est.capture(_nchw(ladder["x"]),
                          torch.from_numpy(ladder["labels"]))
        assert cap.probe_grads == {} and set(cap.param_grads) == set(
            est.metas)


@pytest.mark.parametrize("layer_types", [None, "Linear", "conv",
                                         ["Conv2d", "linear"]])
def test_layer_types_match_jax(ladder, layer_types):
    j = jest.Diagonal(ladder["jm"], ladder["jv"], layer_types=layer_types)
    t = port_est.Diagonal(ladder["tm"], layer_types=layer_types)
    assert list(t.metas) == list(j.metas)


def test_efb_and_inf_check_their_factors(ladder):
    tm, fed = ladder["tm"], ladder["fed"]
    kfac = dict(fed["kfac"].state)
    with pytest.raises(ValueError, match="missing"):
        port_est.EFB(tm, {"fc": kfac["fc"]}, layer_filter=["conv1", "fc"])
    # a plain dense layer's factors with a leading axis are not its own
    # (stacked factors belong to stacked layers): JAX's ValueError
    stacked = dict(kfac, fc={"a": kfac["fc"]["a"][None],
                             "g": kfac["fc"]["g"][None]})
    with pytest.raises(ValueError, match="KFAC-only"):
        port_est.EFB(tm, stacked, layer_filter="fc")
    # per-group factors belong to grouped convs: on a plain conv they are
    # not its own, JAX's ValueError (tests/test_torch_grouped.py runs the
    # grouped ones)
    grouped = dict(kfac, conv1={"a": kfac["conv1"]["a"][None],
                                "g": kfac["conv1"]["g"][None]})
    with pytest.raises(ValueError, match="KFAC-only"):
        port_est.EFB(tm, grouped, layer_filter="conv1")
    split = dict(kfac, fc=dict(kfac["fc"], a_bias=torch.ones(())))
    with pytest.raises(ValueError, match="KFAC-only"):
        port_est.EFB(tm, split, layer_filter="fc")
    efb = fed["efb"]
    wrong = {n: {"a": v["g"], "g": v["a"]} for n, v in efb.eigvecs.items()}
    with pytest.raises(ValueError, match="does not match"):
        port_est.INF(tm, efb.diags, {n: kfac[n] for n in efb.metas},
                     efb.state, eigvecs=wrong)
    with pytest.raises(ValueError, match="same layers"):
        port_est.INF(tm, efb.diags, {"fc": kfac["fc"]}, efb.state)


def test_parts_out_of_this_slice_raise(ladder):
    from curvature_tpu_torch import parallel
    # the model axis is ported (tests/test_torch_model_parallel.py)
    mesh = parallel.make_mesh({"data": 1, "model": 1})
    assert port_est.Diagonal(ladder["tm"]).use_mesh(mesh).mesh is mesh
    # Subspace is ported (tests/test_torch_subspace.py)
    assert port_est.Subspace.__module__ == \
        "curvature_tpu_torch.estimators.subspace"
    # the figures are ported (tests/test_torch_plot.py)
    from curvature_tpu_torch.pipelines import plot
    assert plot.__name__ == "curvature_tpu_torch.pipelines.plot"
    with pytest.raises(AttributeError):
        getattr(port_est, "NoSuchEstimator")
    assert port_est.SWAG.__module__ == "curvature_tpu_torch.estimators.swag"


def test_inf_lazy_eigvecs_match_efb_eigenvalues(ladder):
    """Without shared eigenvectors INF computes them on first use, with
    the eigenvalues of JAX's (checked on the conv1 factors, a separated
    spectrum: the eigenvectors agree up to sign)."""
    fed = ladder["fed"]
    kfac = {"conv1": fed["kfac"].state["conv1"]}
    est = port_est.INF(ladder["tm"], {"conv1": fed["efb"].diags["conv1"]},
                       kfac, {"conv1": fed["efb"].state["conv1"]})
    assert est._eigvecs is None
    u = est.eigvecs["conv1"]["g"]
    want = np.asarray(ladder["j"]["efb"].eigvecs["conv1"]["g"])
    overlap = np.abs(_np(u).T @ want)
    np.testing.assert_allclose(overlap, np.eye(overlap.shape[0]), atol=1e-3)
