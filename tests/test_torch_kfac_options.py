"""KFAC's constructor options against the JAX estimator's
(curvature_tpu/estimators/kfac.py:80-203): ``corr_gram`` switches the
correlation route off, ``corr_gram_min_channels`` is accepted and moves
the gate, and ``max_factor_dim`` raises with JAX's message before any
factor exists."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu import nn as jnn
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.estimators import kfac as tkfac

torch.set_num_threads(1)

#: a 3x3 conv over a 16x16x128 input: the correlation route's shape
X_SHAPE = (2, 16, 16, 128)


@pytest.fixture(scope="module")
def conv_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    tm = tnn.Sequential([tnn.Conv(128, 8, 3, padding=1, name="conv"),
                         tnn.ReLU(), tnn.Flatten(),
                         tnn.Dense(8 * 16 * 16, 10, name="fc")])
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    jm = jnn.Model(jnn.Sequential([jnn.Conv(8, 3, padding=1, name="conv"),
                                   jnn.ReLU(), jnn.Flatten(),
                                   jnn.Dense(10, name="fc")]))
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    return dict(x=x, tm=tm, jm=jm, jv=jv)


@pytest.mark.parametrize("corr_gram", [True, False])
def test_corr_gram_switch_routes_as_jax(conv_pair, corr_gram, monkeypatch):
    """With ``corr_gram=False`` the 128-channel 16x16 conv leaves the
    correlation route in both packages, and its A factor equals JAX's
    (patch route in both, rel 1e-5); with the default it takes it."""
    p = conv_pair
    je = jest.KFAC(p["jm"], p["jv"], use_pallas=False, corr_gram=corr_gram)
    te = port_est.KFAC(p["tm"], use_kernels=False, corr_gram=corr_gram)
    jmeta, tmeta = je.metas["conv"], te.metas["conv"]
    jx = jnp.asarray(p["x"])
    assert je._corr_gram_ok(jmeta, jx) is corr_gram
    assert te._corr_gram_ok(tmeta, torch.from_numpy(p["x"])) is corr_gram
    assert te.a_route(tmeta, X_SHAPE, 4) == ("corr" if corr_gram
                                             else "patches")
    if not corr_gram:
        def refuse(*a, **k):
            raise AssertionError("corr_patch_gram called")
        monkeypatch.setattr(tkfac, "corr_patch_gram", refuse)
    got = te._a_factor(tmeta, torch.from_numpy(p["x"]))
    want = np.asarray(je._a_factor(jmeta, jx))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_corr_gram_min_channels_is_accepted_and_gates(conv_pair):
    """Passing the gate to the constructor raised TypeError before."""
    p = conv_pair
    for channels, ok in ((128, True), (256, False)):
        je = jest.KFAC(p["jm"], p["jv"], use_pallas=False,
                       corr_gram_min_channels=channels)
        te = port_est.KFAC(p["tm"], use_kernels=False,
                        corr_gram_min_channels=channels)
        assert te.corr_gram_min_channels == channels
        assert je._corr_gram_ok(je.metas["conv"],
                                jnp.zeros(X_SHAPE)) is ok
        assert te._corr_gram_ok(te.metas["conv"], X_SHAPE) is ok


@pytest.mark.parametrize("max_dim", [300, 100, 9])
def test_max_factor_dim_guard_raises_as_jax(max_dim):
    """LeNet-5 (fc1 401 columns, conv2 151, fc3 out 10 from 85 inputs):
    the same error and message in both packages, raised before any
    factor is allocated."""
    jm = jmodels.lenet5()
    x = jnp.zeros((1, 28, 28, 1))
    jv = jm.init(jax.random.PRNGKey(0), x)
    tm = tmodels.lenet5(device="cpu")
    with pytest.raises(ValueError) as want:
        jest.KFAC(jm, jv, use_pallas=False, max_factor_dim=max_dim)
    allocated = []
    init_state = port_est.KFAC.init_state

    def spy(self):
        state = init_state(self)
        allocated.append(state)
        return state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_est.KFAC, "init_state", spy)
        with pytest.raises(ValueError) as got:
            port_est.KFAC(tm, max_factor_dim=max_dim)
    assert str(got.value) == str(want.value)
    assert not allocated
    assert port_est.KFAC(tm, max_factor_dim=401).max_factor_dim == 401
