"""Grouped and depthwise convolutions in the port against the JAX package.

The JAX tests' ``_GroupedNet`` (tests/test_grouped.py:31-57: conv ->
grouped conv g=4 -> depthwise s2 -> fc on [4, 6, 6, 3]) is built in both
packages with the same numpy-seeded weights (``models.seeded_variables``
carried into JAX's layout), input and injected MC labels. Each estimator's
state after one update is held against JAX's; EFB and INF are built from
JAX's KFAC factors (EFB's eigenvectors injected: eigh picks its basis
freely inside degenerate eigenspaces, and a depthwise G block is 1x1);
the inverse states, samples (JAX's draws rebuilt from its key schedule),
logdet, quadratic form and solve are held with JAX's states fed to the
port, as tests/test_torch_estimators.py does for ResNet-18. Then the
pieces: the grouped conv's forward, its matrix view, the grouped patch
tokens, the subsampled factors' unbiasedness, "a grouped conv is g
parallel convs", the within-group correlation Gram and the packed
grouped Gram.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import nn as jnn
from curvature_tpu.estimators import base as jbase
from curvature_tpu.nn import core as jcore
from curvature_tpu.ops import corr_gram as jcorr
from curvature_tpu.ops import linalg as jlinalg
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.estimators import base as tbase
from curvature_tpu_torch.nn import core as tcore
from curvature_tpu_torch.ops import corr_gram as tcorr
from curvature_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(1)

ADD, MULTIPLY = 1.0, 50.0
#: INF's rank: the grouped conv's groups hold 2 x 19 = 38 entries each, so
#: 20 makes each group's selection non-trivial; the depthwise groups'
#: 1 x 10 = 10 are kept whole
RANK = 20
KINDS = ("kfac", "diag", "block", "efb", "inf")


class _JGroupedNet(jnn.Module):
    """conv -> grouped conv -> depthwise conv -> fc (JAX)."""

    def __init__(self):
        self.c1 = jnn.Conv(8, 3, padding=1, name="c1")
        self.c2 = jnn.Conv(8, 3, padding=1, groups=4, name="c2")
        self.dw = jnn.Conv(8, 3, strides=2, padding=1, groups=8, name="dw")
        self.fc = jnn.Dense(5, name="fc")

    def __call__(self, ctx, x):
        x = jnn.ReLU()(ctx, self.c1(ctx, x))
        x = jnn.ReLU()(ctx, self.c2(ctx, x))
        x = jnn.ReLU()(ctx, self.dw(ctx, x))
        x = jnn.Flatten()(ctx, x)
        return self.fc(ctx, x)


def _t_grouped_net():
    return tnn.Sequential([
        tnn.Conv(3, 8, 3, padding=1, name="c1"), tnn.ReLU(),
        tnn.Conv(8, 8, 3, padding=1, groups=4, name="c2"), tnn.ReLU(),
        tnn.Conv(8, 8, 3, 2, padding=1, groups=8, name="dw"), tnn.ReLU(),
        tnn.Flatten(), tnn.Dense(72, 5, name="fc")])


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _to_port(state):
    return tmodels.state_from_jax(state, "cpu")


def _pair(jmodule, tm, x_shape, seed=0):
    """A JAX model and the port's with the same seeded weights."""
    variables = tmodels.seeded_variables(tm, seed)
    tmodels.load_jax_variables(tm, variables)
    jm = jnn.Model(jmodule)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros(x_shape, jnp.float32)))
    return jm, jax.tree_util.tree_map(jnp.asarray, variables)


@pytest.fixture(scope="module")
def grouped():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2, 4)).astype(np.int32)   # [S, B]
    tm = _t_grouped_net()
    jm, jv = _pair(_JGroupedNet(), tm, x.shape)
    jx, jl = jnp.asarray(x), jnp.asarray(labels)
    tx, tl = _nchw(x), torch.from_numpy(labels)

    j, t = {}, {}
    j["kfac"] = jest.KFAC(jm, jv, use_pallas=False)
    t["kfac"] = port_est.KFAC(tm)
    for kind, cls in (("diag", "Diagonal"), ("block", "BlockDiagonal")):
        j[kind] = getattr(jest, cls)(jm, jv)
        t[kind] = getattr(port_est, cls)(tm)
    for kind in ("kfac", "diag", "block"):
        j[kind].update(jx, labels=jl)
        t[kind].update(tx, labels=tl)
    kfac_state = _to_port(j["kfac"].state)
    j["efb"] = jest.EFB(jm, jv, j["kfac"].state)
    j["efb"].update(jx, labels=jl)
    t["efb"] = port_est.EFB(tm, kfac_state)
    t["efb"].eigvecs = _to_port(j["efb"].eigvecs)
    t["efb"].update(tx, labels=tl)
    j["inf"] = jest.INF(jm, jv, j["efb"].diags, j["kfac"].state,
                        j["efb"].state, eigvecs=j["efb"].eigvecs)
    j["inf"].update(rank=RANK)
    t["inf"] = port_est.INF(tm, _to_port(j["efb"].diags), kfac_state,
                            _to_port(j["efb"].state),
                            eigvecs=_to_port(j["efb"].eigvecs))
    t["inf"].update(rank=RANK)
    fed = {"kfac": port_est.KFAC(tm), "inf": t["inf"]}
    fed["kfac"].state = kfac_state
    for kind in ("diag", "block"):
        fed[kind] = type(t[kind])(tm)
        fed[kind].state = _to_port(j[kind].state)
    fed["efb"] = port_est.EFB(tm, kfac_state)
    fed["efb"].eigvecs = _to_port(j["efb"].eigvecs)
    fed["efb"].state = _to_port(j["efb"].state)
    for kind in KINDS:
        assert list(fed[kind].metas) == list(j[kind].metas), kind
        j[kind].invert(ADD, MULTIPLY)
        fed[kind].invert(ADD, MULTIPLY)
    return dict(x=x, labels=labels, jm=jm, jv=jv, tm=tm, j=j, t=t, fed=fed)


# -- the estimators' states ---------------------------------------------------

def test_grouped_metas_match_jax(grouped):
    for name, m in grouped["jm"].metas.items():
        t = grouped["tm"].metas[name]
        assert (t.out_features, t.fan_in, t.has_bias, t.groups) \
            == (m.out_features, m.fan_in, m.has_bias, m.groups), name


def test_kfac_grouped_factors_match_jax(grouped):
    """Per-group [g, cols, cols] A and [g, og, og] G (a depthwise G is
    [8, 1, 1]): 1e-4 of max, the G factors' gradients run back through
    the same ReLUs in f32."""
    j, t = grouped["j"]["kfac"], grouped["t"]["kfac"]
    assert t.state["c2"]["a"].shape == (4, 19, 19)
    assert t.state["dw"]["g"].shape == (8, 1, 1)
    for name in j.metas:
        for key in "ag":
            _close(t.state[name][key], j.state[name][key], 1e-4,
                   f"{name} {key}")


@pytest.mark.parametrize("kind", ["diag", "block"])
def test_gradient_moment_states_match_jax(grouped, kind):
    """Diagonal and Block take the grouped weight's gradient in the [out,
    (C/g)*kh*kw(+1)] view: no grouped branch, the same numbers (1e-4 of
    max)."""
    j, t = grouped["j"][kind], grouped["t"][kind]
    for name in j.metas:
        _close(t.state[name], j.state[name], 1e-4, name)


def test_efb_grouped_lambdas_and_diags_match_jax(grouped):
    """JAX's eigenvectors injected: the per-group eigenbasis moments [g,
    og, cols] and the free diagonal [out, cols], 1e-4 of max."""
    j, t = grouped["j"]["efb"], grouped["t"]["efb"]
    assert t.state["c2"].shape == (4, 2, 19)
    for name in j.metas:
        _close(t.state[name], j.state[name], 1e-4, f"{name} lambdas")
        _close(t.diags[name], j.diags[name], 1e-4, f"{name} diags")


def test_inf_grouped_state_matches_jax(grouped):
    """The per-group index sets gather bit-equal eigenvector columns and
    lambdas; the diagonal correction within 1e-5 of max."""
    j, t = grouped["j"]["inf"], grouped["t"]["inf"]
    assert t.state["c2"]["ua"].shape[0] == 4
    for name in j.metas:
        for key in ("ua", "ug", "lam"):
            np.testing.assert_array_equal(_np(t.state[name][key]),
                                          np.asarray(j.state[name][key]),
                                          err_msg=f"{name} {key}")
        _close(t.state[name]["corr"], j.state[name]["corr"], 1e-5,
               f"{name} corr")


# -- the Gaussian API with JAX's states fed to the port -----------------------

@pytest.mark.parametrize("kind", KINDS)
def test_grouped_inverse_state_matches_jax(grouped, kind):
    """1e-4 of max: KFAC's per-group inverse Choleskys (1x1 for the
    depthwise G), the elementwise inverses, Block's inverse Cholesky,
    INF's per-group Woodbury caches."""
    j, t = grouped["j"][kind], grouped["fed"][kind]
    for name in j.metas:
        if kind == "kfac":
            for key in ("a_chol", "g_chol"):
                _close(t.inv_state[name][key], j.inv_state[name][key],
                       1e-4, f"{name} {key}")
        elif kind == "efb":
            _close(t.inv_state["ilam"][name], j.inv_state["ilam"][name],
                   1e-4, name)
        elif kind == "inf":
            for key in ("inv_corr", "pre"):
                _close(t.inv_state[name][key], j.inv_state[name][key], 1e-4,
                       f"{name} {key}")
        else:
            _close(t.inv_state[name], j.inv_state[name], 1e-4, name)


def _jax_noise(kind, j, t, seed):
    """JAX's draws: one key per layer split off in meta order; KFAC, EFB,
    Diagonal and Block draw ``normal(key, shape)`` at the port's noise
    shape (JAX's: [g, cols, og] for a grouped conv), INF splits each
    grouped layer's key once per group and draws [cols*og] per group
    (inf.py:508-519)."""
    rng = jax.random.PRNGKey(seed)
    noise = {}
    for name, shape in t.noise_shapes().items():
        rng, key = jax.random.split(rng)
        if kind == "inf" and len(shape) == 2:
            noise[name] = np.stack([
                np.array(jax.random.normal(k, shape[1:], jnp.float32))
                for k in jax.random.split(key, shape[0])])
        else:
            noise[name] = np.array(jax.random.normal(key, shape,
                                                     jnp.float32))
    assert list(noise) == list(j.metas)
    return noise


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_samples_match_jax_with_the_same_draws(grouped, kind):
    """5e-4 of max (tests/test_torch_estimators.py's bar). A group axis
    transposed against JAX's would still give a valid-looking sample:
    only this element-wise comparison catches it."""
    j, t = grouped["j"][kind], grouped["fed"][kind]
    want = j.sample(jax.random.PRNGKey(5))
    got = t.sample(noise=_jax_noise(kind, j, t, 5))
    for name, meta in j.metas.items():
        assert got[name].shape == (meta.out_features, meta.mat_cols)
        _close(got[name], want[name], 5e-4, f"{name} sample")


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_logdet_matches_jax(grouped, kind):
    j, t = grouped["j"][kind], grouped["fed"][kind]
    want = j.logdet_precision(ADD, MULTIPLY)
    got = t.logdet_precision(ADD, MULTIPLY)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _deltas(j, seed):
    rng = np.random.default_rng(seed)
    return {name: (0.01 * rng.standard_normal(
        (m.out_features, m.mat_cols))).astype(np.float32)
        for name, m in j.metas.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_quadratic_form_matches_jax(grouped, kind):
    j, t = grouped["j"][kind], grouped["fed"][kind]
    d = _deltas(j, 6)
    want = j.quadratic_form({k: jnp.asarray(v) for k, v in d.items()},
                            ADD, MULTIPLY)
    got = t.quadratic_form(d, ADD, MULTIPLY)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_precision_solve_matches_jax(grouped, kind):
    """1e-4 of max per layer at damping (1, 1), the bar and damping of
    tests/test_torch_estimators.py."""
    j, t = grouped["j"][kind], grouped["fed"][kind]
    d = _deltas(j, 7)
    want = j.precision_solve({k: jnp.asarray(v) for k, v in d.items()},
                             1.0, 1.0)
    got = t.precision_solve(d, 1.0, 1.0)
    for name in j.metas:
        _close(got[name], want[name], 1e-4, name)


def test_grouped_posterior_forward_is_finite(grouped):
    """A KFAC posterior sample through the grouped model's forward."""
    tm, est = grouped["tm"], grouped["fed"]["kfac"]
    params = est.posterior_params(generator=torch.Generator().manual_seed(0))
    full = dict(tm.state_dict())
    full.update(params)
    with torch.no_grad():
        out = torch.func.functional_call(tm, full, (_nchw(grouped["x"]),))
    assert out.shape == (4, 5) and torch.isfinite(out).all()


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("groups,cin,cout,stride,bias", [
    (4, 8, 8, 1, True), (2, 8, 4, 2, True), (8, 8, 8, 1, False)])
def test_grouped_conv_forward_matches_jax(groups, cin, cout, stride, bias):
    """The JAX test's cases (tests/test_grouped.py:66-85): 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 6, cin)).astype(np.float32)
    k = rng.standard_normal((3, 3, cin // groups, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    params = {"kernel": jnp.asarray(k)}
    if bias:
        params["bias"] = jnp.asarray(b)
    want = jnn.Conv(cout, 3, strides=stride, padding=1, groups=groups,
                    use_bias=bias, name="c")(jcore.Context({"c": params}),
                                             jnp.asarray(x))
    conv = tnn.Conv(cin, cout, 3, stride, padding=1, bias=bias,
                    groups=groups, name="c")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
        got = conv(_nchw(x)).permute(0, 2, 3, 1)
    _close(got, want, 1e-5, "grouped conv")
    assert conv.meta.fan_in == cin // groups * 9
    assert conv.meta.groups == groups


@pytest.mark.parametrize("name", ["ReLU6", "SiLU", "Hardsigmoid",
                                  "Hardswish", "GELU", "Identity", "AvgPool",
                                  "AdaptiveAvgPool", "Add"])
def test_family_glue_layers_match_jax(name):
    """The activations, pools and residual add of the families' glue
    against JAX's layers (layers.py:211-352) on NCHW / NHWC copies of one
    input: 1e-6 of max (erf GELU, not tanh; AvgPool's padding counted in
    the divisor; AdaptiveAvgPool's torch bins on a 7 x 5 map)."""
    x = np.random.default_rng(8).standard_normal((2, 7, 5, 4)) \
        .astype(np.float32) * 4
    k = np.random.default_rng(9).standard_normal((1, 1, 4, 4)) \
        .astype(np.float32)
    jctx = jcore.Context({"c": {"kernel": jnp.asarray(k)}})
    if name == "AvgPool":
        jl, tl = jnn.AvgPool(3, 2, padding=1), tnn.AvgPool(3, 2, padding=1)
    elif name == "AdaptiveAvgPool":
        jl, tl = jnn.AdaptiveAvgPool((3, 2)), tnn.AdaptiveAvgPool((3, 2))
    elif name == "Add":
        jl = jnn.Add(jnn.Conv(4, 1, use_bias=False, name="c"),
                     jnn.Identity())
        conv = tnn.Conv(4, 4, 1, bias=False, name="c")
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)
                                               .copy()))
        tl = tnn.Add(conv, tnn.Identity())
    else:
        jl, tl = getattr(jnn, name)(), getattr(tnn, name)()
    want = jl(jctx, jnp.asarray(x))
    with torch.no_grad():
        got = (tl(_nchw(x), None) if name == "Add" else tl(_nchw(x)))
    _close(got.permute(0, 2, 3, 1), want, 1e-6, name)


def test_kfac_refuses_a_grouped_conv_inside_scan_blocks():
    """JAX's error (kfac.py:308-312) for a grouped conv's meta that also
    carries a ScanBlocks depth."""
    class Stacked(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        @property
        def metas(self):
            return {"c": tcore.LayerMeta("c", "conv", 8, 18, False, (3, 3),
                                         (1, 1), "SAME", stacked=2,
                                         groups=4)}
    with pytest.raises(ValueError, match="grouped convs inside ScanBlocks"):
        port_est.KFAC(Stacked())


def test_grouped_conv_divisibility_errors():
    with pytest.raises(ValueError, match="must divide out features"):
        tnn.Conv(8, 6, 3, groups=4)
    with pytest.raises(ValueError, match="must divide input channels"):
        tnn.Conv(6, 8, 3, groups=4, name="c")


def test_grouped_matrix_view_matches_jax(grouped):
    """``param_matrix`` of the grouped [O, C/g, kh, kw] weight equals
    JAX's view of its HWIO kernel (rows group-major), and
    ``matrix_to_delta`` inverts it exactly."""
    tm, jm, jv = grouped["tm"], grouped["jm"], grouped["jv"]
    for name in ("c2", "dw"):
        meta = tm.metas[name]
        mod = getattr(tm, name)
        mat = tcore.param_matrix(meta, mod.weight, mod.bias)
        want = jcore.param_matrix(jm.metas[name], jv["params"][name])
        np.testing.assert_array_equal(_np(mat), np.asarray(want))
        back = tcore.matrix_to_delta(meta, mat)
        assert torch.equal(back["weight"], mod.weight)
        assert torch.equal(back["bias"], mod.bias)


@pytest.mark.parametrize("stride,offset", [(1, (0, 0)), (2, (0, 0)),
                                           (2, (1, 0)), (2, (1, 1))])
def test_grouped_act_tokens_match_jax(grouped, stride, offset):
    """[N, g, fan_in + 1] per-group patch tokens with the per-group ones
    column, on the full and the subsampled grids: bit-equal copies."""
    tm, jm = grouped["tm"], grouped["jm"]
    x = np.random.default_rng(3).standard_normal((2, 6, 6, 8)) \
        .astype(np.float32)
    for name in ("c2", "dw"):
        got = tbase.grouped_act_tokens(tm.metas[name], torch.from_numpy(x),
                                       True, stride, offset)
        want = jbase.grouped_act_tokens(jm.metas[name], jnp.asarray(x),
                                        True, stride, offset)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    with pytest.raises(ValueError, match="grouped_act_tokens"):
        tbase.act_tokens(tm.metas["c2"], torch.from_numpy(x))


class _TwoParallel(tnn.CtxModule):
    """Two independent convs on channel halves: one grouped conv, split."""

    def __init__(self):
        super().__init__()
        self.ca = tnn.Conv(2, 2, 3, padding=1, name="ca")
        self.cb = tnn.Conv(2, 2, 3, padding=1, name="cb")
        self.fc = tnn.Dense(100, 5, name="fc")

    @property
    def metas(self):
        return {m.name: m.meta for m in (self.ca, self.cb, self.fc)}

    def forward(self, x, ctx=None):
        y = torch.cat([self.ca(x[:, :2], ctx), self.cb(x[:, 2:], ctx)], 1)
        return self.fc(torch.relu(y).flatten(1), ctx)


def test_kfac_grouped_equals_parallel_convs():
    """A grouped conv is g parallel convs (tests/test_grouped.py:129):
    with the same weights, input and labels, group j's factors equal the
    j-th split conv's, 1e-6 of max (the same products)."""
    rng = np.random.default_rng(4)
    x = _nchw(rng.standard_normal((4, 5, 5, 4)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, size=(2, 4)))
    split = _TwoParallel()
    grouped = tnn.Sequential([
        tnn.Conv(4, 4, 3, padding=1, groups=2, name="c"), tnn.ReLU(),
        tnn.Flatten(), tnn.Dense(100, 5, name="fc")])
    with torch.no_grad():
        grouped.c.weight.copy_(torch.cat([split.ca.weight,
                                          split.cb.weight]))
        grouped.c.bias.copy_(torch.cat([split.ca.bias, split.cb.bias]))
        grouped.fc.weight.copy_(split.fc.weight)
        grouped.fc.bias.copy_(split.fc.bias)
        _close(grouped(x), split(x), 1e-6, "logits")
    es, eg = port_est.KFAC(split), port_est.KFAC(grouped)
    es.update(x, labels=labels)
    eg.update(x, labels=labels)
    for j, name in enumerate(("ca", "cb")):
        for key in "ag":
            _close(eg.state["c"][key][j], es.state[name][key], 1e-6,
                   f"{name} {key}")


def test_kfac_grouped_subsample_unbiased_and_matches_jax(grouped):
    """The k^2 offset grids partition the grouped layers' tokens: the
    count-weighted average of the subsampled factors equals the full
    factor (tests/test_grouped.py:200), 1e-5 of max; each subsampled
    factor matches JAX's at the same offset, 1e-4 of max."""
    tm, jm, jv = grouped["tm"], grouped["jm"], grouped["jv"]
    x, labels = grouped["x"], grouped["labels"][:1]
    kw = {"layer_filter": ["c2", "dw"]}
    full = port_est.KFAC(tm, **kw)
    full.update(_nchw(x), labels=torch.from_numpy(labels))
    k, acc, weights = 2, {}, {}
    for o0 in range(k):
        for o1 in range(k):
            est = port_est.KFAC(tm, token_subsample=1.0 / k ** 2,
                                subsample_offset=(o0, o1), **kw)
            est.update(_nchw(x), labels=torch.from_numpy(labels))
            je = jest.KFAC(jm, jv, use_pallas=False,
                           token_subsample=1.0 / k ** 2,
                           subsample_offset=(o0, o1), **kw)
            je.update(jnp.asarray(x), labels=jnp.asarray(labels))
            for name, meta in est.metas.items():
                h_out = 6 // meta.strides[0]
                cnt = 4 * len(range(o0, h_out, k)) * len(range(o1, h_out, k))
                a = est.state[name]["a"] * cnt
                acc[name] = acc.get(name, 0) + a
                weights[name] = weights.get(name, 0) + cnt
                for key in "ag":
                    _close(est.state[name][key], je.state[name][key], 1e-4,
                           f"{name} {key} offset {(o0, o1)}")
    for name in acc:
        _close(acc[name] / weights[name], full.state[name]["a"], 1e-5, name)


@pytest.mark.parametrize("shape,groups,ks,padding,has_bias", [
    ((2, 7, 7, 8), 4, (3, 3), ((1, 1), (1, 1)), True),
    ((2, 7, 7, 8), 4, (3, 3), ((1, 1), (1, 1)), False),
    ((2, 6, 6, 6), 6, (3, 3), "SAME", True),
    ((2, 6, 6, 6), 6, (3, 3), "SAME", False),
    ((1, 9, 9, 4), 2, (5, 5), ((2, 2), (2, 2)), True),
    ((2, 8, 8, 4), 4, (3, 3), "VALID", False),
])
def test_corr_gram_grouped_matches_einsum_and_jax(shape, groups, ks,
                                                  padding, has_bias):
    """``corr_patch_gram(groups=g)`` (f32) against the per-group Gram of
    the grouped patch tokens in float64 (1e-6 of max: f32 sums of ~100
    products) and JAX's (1e-5 of max)."""
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    got = tcorr.corr_patch_gram(torch.from_numpy(x), ks, padding, has_bias,
                                groups)
    meta = tcore.LayerMeta("c", "conv", groups, shape[-1] // groups
                           * ks[0] * ks[1], has_bias, ks, (1, 1), padding,
                           groups=groups)
    t = tbase.grouped_act_tokens(meta, torch.from_numpy(x).double(),
                                 has_bias)
    want = torch.einsum("ngi,ngj->gij", t, t)
    _close(got, want, 1e-6, "corr vs einsum")
    jax_gram = jcorr.corr_patch_gram(jnp.asarray(x), ks, padding, has_bias,
                                     groups)
    _close(got, jax_gram, 1e-5, "corr vs JAX")


def test_kfac_corr_gram_grouped_route_matches_default():
    """``corr_gram_grouped=True`` with the gate opened to this size takes
    the correlation route for the stride-1 grouped conv (``a_route``) and
    gives the einsum route's factors, 1e-5 of max; the stride-2 depthwise
    conv stays on the einsum route."""
    tm = _t_grouped_net()
    tmodels.load_jax_variables(tm, tmodels.seeded_variables(tm, 1))
    x = _nchw(np.random.default_rng(6).standard_normal((4, 6, 6, 3))
              .astype(np.float32))
    labels = torch.tensor([[0, 1, 2, 3]])
    gate = dict(corr_gram_min_channels=1, corr_gram_min_extent=1)
    plain = port_est.KFAC(tm, **gate)
    corr = port_est.KFAC(tm, corr_gram_grouped=True, **gate)
    shape = (4, 6, 6, 8)
    assert plain.a_route(tm.metas["c2"], shape, 4) == "grouped"
    assert corr.a_route(tm.metas["c2"], shape, 4) == "corr"
    assert corr.a_route(tm.metas["dw"], shape, 4) == "grouped"
    for e in (plain, corr):
        e.update(x, labels=labels)
    for name in ("c2", "dw"):
        _close(corr.state[name]["a"], plain.state[name]["a"], 1e-5, name)


@pytest.mark.parametrize("n,g,c", [(50, 7, 10), (64, 32, 37), (30, 3, 200),
                                   (16, 96, 10)])
def test_grouped_gram_packed_matches_jax(n, g, c):
    """The packed per-group Grams against JAX's and the plain batched
    product: f32, 1e-5 of max (the same token products, summed in other
    orders)."""
    t = np.random.default_rng(n + g).standard_normal((n, g, c)) \
        .astype(np.float32)
    got = tlinalg.grouped_gram_packed(torch.from_numpy(t))
    _close(got, jlinalg.grouped_gram_packed(jnp.asarray(t)), 1e-5, "JAX")
    _close(got, np.einsum("ngi,ngj->gij", t.astype(np.float64), t), 1e-5,
           "plain")


def test_kfac_grouped_noise_and_state_shapes(grouped):
    """JAX's layouts: KFAC and EFB noise [g, cols, og], INF [g, cols*og],
    EFB moments [g, og, cols] beside a [out, cols] free diagonal."""
    fed = grouped["fed"]
    assert fed["kfac"].noise_shapes()["c2"] == (4, 19, 2)
    assert fed["efb"].noise_shapes()["dw"] == (8, 10, 1)
    assert fed["inf"].noise_shapes()["c2"] == (4, 38)
    assert fed["efb"].diags["c2"].shape == (8, 19)
