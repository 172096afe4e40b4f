"""Port parity of the ResNet models: the same numpy-seeded weights through
``curvature_tpu.models`` and ``curvature_tpu_torch.models`` (converted by
``models.convert``), logits in train (batch-statistics) and eval
(running-statistics) BN mode, and the BN running-statistics update."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import models as jmodels
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.nn import LayerMeta

torch.set_num_threads(1)


def _pair(arch, size, batch, seed=0):
    """(jax model, jax variables, port model, NHWC numpy input)."""
    if arch == "resnet18":
        jm = jmodels.resnet18(num_classes=10)
        tm = tmodels.resnet18(num_classes=10, device="cpu")
    else:
        jm = jmodels.resnet50(num_classes=1000)
        tm = tmodels.resnet50(num_classes=1000, device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch, size, size, 3)).astype(np.float32)
    # the JAX tree structure, abstractly (no FLOPs)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    variables = tmodels.seeded_variables(tm, seed)
    assert jax.tree_util.tree_structure(shapes) \
        == jax.tree_util.tree_structure(variables)
    for s, v in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(variables)):
        assert s.shape == v.shape
    tmodels.load_jax_variables(tm, variables)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm, x


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("arch,size,batch", [("resnet18", 32, 2),
                                             ("resnet50", 64, 1)])
@pytest.mark.parametrize("train", [False, True])
def test_resnet_logits_match_jax(arch, size, batch, train):
    """1e-5 of max|logit|: f32 convs and BN in another summation order."""
    jm, jv, tm, x = _pair(arch, size, batch)
    want, _ = jm.apply(jv, jnp.asarray(x), train=train)
    tm.train(train)
    with torch.no_grad():
        got = tm(_nchw(x))
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_metas_match_jax():
    """Tracked layers: same names, same order, same shapes and padding."""
    jm, jv, tm, x = _pair("resnet18", 32, 2)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tmetas = tm.metas
    assert list(tmetas) == list(jm.metas)
    for name, jmeta in jm.metas.items():
        t = tmetas[name]
        assert isinstance(t, LayerMeta)
        assert (t.kind, t.out_features, t.fan_in, t.has_bias) == \
            (jmeta.kind, jmeta.out_features, jmeta.fan_in, jmeta.has_bias)
        if t.kind == "conv":
            assert (t.kernel_size, t.strides, t.padding) == \
                (jmeta.kernel_size, jmeta.strides, jmeta.padding)


def test_batchnorm_running_stats_update_matches_jax():
    """Train mode without a capture context updates the running stats
    (momentum 0.1, unbiased variance) exactly as the JAX apply reports
    them; rtol 1e-5."""
    jm, jv, tm, x = _pair("resnet18", 32, 2)
    _, aux = jm.apply(jv, jnp.asarray(x), train=True)
    tm.train()
    with torch.no_grad():
        tm(_nchw(x))
    sd = tm.state_dict()
    for layer, stats in aux["batch_stats"].items():
        np.testing.assert_allclose(sd[f"{layer}.running_mean"].numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(sd[f"{layer}.running_var"].numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5,
                                   atol=1e-6)


def test_capture_context_leaves_running_stats():
    """The estimator's capture (train mode under a Context) must not move
    the running statistics: the JAX collect discards them."""
    from curvature_tpu_torch.nn import Context
    _, _, tm, x = _pair("resnet18", 32, 2)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.train()
    with torch.no_grad():
        tm(_nchw(x), Context(track=tm.metas))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_matrix_views_match_jax():
    """param_matrix / matrix_to_delta / apply_matrix_delta against the
    JAX matrix view (exact: reshapes and one add, atol 1e-7)."""
    from curvature_tpu.nn import core as jcore
    from curvature_tpu_torch.nn import core as tcore
    jm, jv, tm, x = _pair("resnet18", 32, 2)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    own = {k: v.detach() for k, v in tm.named_parameters()}
    rng = np.random.default_rng(3)
    deltas = {}
    for name in ("conv1", "layer2.0.conv1", "layer2.0.downsample.0", "fc"):
        meta = tm.metas[name]
        want = np.asarray(jcore.param_matrix(jm.metas[name],
                                             jv["params"][name]))
        got = tcore.param_matrix(meta, own[f"{name}.weight"],
                                 own.get(f"{name}.bias"))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
        back = tcore.matrix_to_delta(meta, got)
        assert torch.equal(back["weight"], own[f"{name}.weight"])
        deltas[name] = rng.standard_normal(want.shape).astype(np.float32)
    mean = own
    new = tcore.apply_matrix_delta(
        tm.metas, mean, {k: torch.from_numpy(v) for k, v in deltas.items()})
    jnew = jcore.apply_matrix_delta(
        jm.metas, jv["params"], {k: jnp.asarray(v) for k, v in
                                 deltas.items()})
    for name in deltas:
        w = new[f"{name}.weight"].numpy()
        w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
        np.testing.assert_allclose(w, np.asarray(jnew[name]["kernel"]),
                                   atol=1e-6)
    np.testing.assert_allclose(new["fc.bias"].numpy(),
                               np.asarray(jnew["fc"]["bias"]), atol=1e-6)
    assert new["layer1.0.conv1.weight"] is mean["layer1.0.conv1.weight"]
