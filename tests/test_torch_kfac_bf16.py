"""KFAC's ``token_subsample`` and ``compute_dtype`` options: the port
against the JAX package on the ResNet-18 pair (CIFAR stem, 32², B=2,
injected labels), with the same numpy-seeded inputs and weights.

The port runs ``use_kernels=True``, so on the CPU the patch-Gram kernels'
plain versions run; JAX runs ``use_pallas=False``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.utils import casting as jcasting
from curvature_tpu_torch import estimators as torch_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.ops.cuda import patch_gram as tpg
from curvature_tpu_torch.utils import cast_floats, cast_input

torch.set_num_threads(1)

LAYERS = ["conv1", "layer1.*", "layer2.*", "layer3.*", "fc"]
#: bf16 compute against f32 factors (tests/test_capture.py:137)
BF16_RTOL = 2e-2


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel(got, want):
    """max |got - want| / max |want|."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(shape, seed):
    """Numpy normals rounded to bf16: a bf16 tensor for the port and the
    same values as a bf16 array for JAX."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _models(residual_gain):
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = jmodels.resnet18(num_classes=10)
    tm = tmodels.resnet18(num_classes=10, device="cpu")
    variables = tmodels.seeded_variables(tm, 0, residual_gain=residual_gain)
    tmodels.load_jax_variables(tm, variables)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    return dict(x=x, labels=np.array([[3, 7]], np.int32), jm=jm,
                jv=jax.tree_util.tree_map(jnp.asarray, variables), tm=tm)


def _estimators(m, jax_kw=None, torch_kw=None, update=True):
    """A JAX and a port KFAC on the pair's models, both updated once with
    the pair's batch and labels."""
    je = jest.KFAC(m["jm"], m["jv"], use_pallas=False, corr_gram_min_extent=8,
                   layer_filter=LAYERS, **(jax_kw or {}))
    te = torch_est.KFAC(m["tm"], use_kernels=True, corr_gram_min_extent=8,
                        layer_filter=LAYERS, **(torch_kw or {}))
    if update:
        je.update(jnp.asarray(m["x"]), labels=jnp.asarray(m["labels"]))
        te.update(_nchw(m["x"]), labels=torch.from_numpy(m["labels"]))
    return je, te


@pytest.fixture(scope="module")
def pair():
    """Undamped residual branches (as tests/test_torch_kfac.py): the best
    conditioned f32 G factors."""
    return _models(1.0)


# -- token_subsample (f32) ---------------------------------------------------

@pytest.mark.parametrize("offset", [(0, 0), (1, 1)])
def test_token_subsample_factors_match_jax(pair, offset):
    """k = 2 grids at both offsets: A at 1e-5 of max|A|, G at 1e-4 of
    max|G|, the bars of the full factors (tests/test_torch_kfac.py)."""
    kw = dict(token_subsample=0.25, subsample_offset=offset)
    je, te = _estimators(pair, kw, kw)
    assert te._spatial_stride() == je._spatial_stride() == 2
    for name in je.metas:
        assert _rel(te.state[name]["a"], je.state[name]["a"]) <= 1e-5, name
        assert _rel(te.state[name]["g"], je.state[name]["g"]) <= 1e-4, name


def test_offset_average_equals_full_factor(pair):
    """The unbiasedness contract (tests/test_estimators.py:270): the k^2
    offset grids partition the positions, so the mean of the subsampled
    factors over all offsets is the full factor. Every conv grid of the
    32² pair is even, so each offset has the same token count. 1e-5 of
    max: the full factor takes the kernel and correlation routes, the
    subsampled ones the patch route, so only f32 rounding differs."""
    tm, x = pair["tm"], _nchw(pair["x"])
    labels = torch.from_numpy(pair["labels"])
    full = torch_est.KFAC(tm, use_kernels=True, corr_gram_min_extent=8,
                          layer_filter=LAYERS)
    full.update(x, labels=labels)
    states = []
    for offset in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        sub = torch_est.KFAC(tm, use_kernels=True, layer_filter=LAYERS,
                             token_subsample=0.25, subsample_offset=offset)
        sub.update(x, labels=labels)
        states.append(sub.state)
    for name, fac in full.state.items():
        for key in ("a", "g"):
            mean = torch.stack([s[name][key] for s in states]).mean(0)
            assert _rel(mean, fac[key].numpy()) <= 1e-5, f"{name} {key}"


@pytest.mark.parametrize("kw", [
    dict(token_subsample=0.25, subsample_offset=(2, 0)),
    dict(token_subsample=0.25, subsample_offset=(0, -1)),
    dict(token_subsample=1.0, subsample_offset=(1, 0)),
    dict(token_subsample=0.0),
    dict(token_subsample=1.5),
])
def test_subsample_options_validated_like_jax(pair, kw):
    """An offset outside [0, k) per dim, or a fraction outside (0, 1],
    raises in both packages (JAX kfac.py:178-179, 204-212)."""
    with pytest.raises(ValueError):
        jest.KFAC(pair["jm"], pair["jv"], use_pallas=False, **kw)
    with pytest.raises(ValueError):
        torch_est.KFAC(pair["tm"], **kw)


# -- bf16 A factor, route by route -------------------------------------------

@pytest.mark.parametrize("route,layer,shape,kw", [
    ("patches", "layer1.0.conv1", (2, 16, 16, 64), {}),
    ("corr", "layer2.0.conv2", (2, 8, 8, 128), {}),
    ("v2", "layer3.0.conv1", (2, 8, 8, 128), {}),
    ("subsampled", "layer2.0.conv2", (2, 8, 8, 128),
     dict(token_subsample=0.25)),
    ("subsampled", "layer1.0.conv1", (2, 16, 16, 64),
     dict(token_subsample=0.25, subsample_offset=(1, 1))),
])
def test_bf16_a_factor_matches_jax(pair, route, layer, shape, kw):
    """The same bf16 activations through the port's and JAX's
    ``_a_factor``, at 1e-5 of max|A|: bf16 operands, exact products, f32
    sums in both (the port's v2 route is the kernel's plain version here,
    JAX's the patch einsum)."""
    je, te = _estimators(pair, kw, kw, update=False)
    meta = te.metas[layer]
    act, jact = _bf16(shape, seed=3)
    if route == "subsampled":
        assert te._spatial_stride() == 2
    else:
        which = tpg.select_patch_gram(shape[-1], meta.kernel_size,
                                      meta.strides, shape[1], shape[2],
                                      shape[0], act.element_size())
        got_route = ("corr" if te._corr_gram_ok(meta, act)
                     else which or "patches")
        assert got_route == route
    got = te._a_factor(meta, act)
    assert got.dtype == torch.float32
    assert _rel(got, je._a_factor(je.metas[layer], jact)) <= 1e-5


# -- the bf16 slice ----------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_slice():
    """bf16 and f32 factors of both packages from one batch. The default
    residual gain (0.2) here: with undamped branches the bf16 forward
    drifts past 2e-2 of max|A| by layer3 in both packages alike."""
    m = _models(0.2)
    je, te = _estimators(m, dict(compute_dtype=jnp.bfloat16),
                         dict(compute_dtype=torch.bfloat16))
    je32, te32 = _estimators(m)
    return dict(je=je, te=te, je32=je32, te32=te32, m=m)


def test_bf16_slice_a_factors(bf16_slice):
    """Every layer's bf16 A factor within 2e-2 of max of JAX's bf16 one
    and of the port's own f32 one (the bar of tests/test_capture.py)."""
    s = bf16_slice
    for name in s["je"].metas:
        a = s["te"].state[name]["a"]
        assert a.dtype == torch.float32
        assert _rel(a, s["je"].state[name]["a"]) <= BF16_RTOL, name
        assert _rel(a, s["te32"].state[name]["a"].numpy()) <= BF16_RTOL, name


def test_bf16_capture_rounds_bn_parameters(bf16_slice):
    """JAX casts every float parameter, BN scale and bias included, before
    the BN math in f32. layer1.0.conv1's input has passed one bf16 conv and
    one BN: its A factor agrees with JAX's at 2e-3 of max (measured 9.5e-4:
    the two bf16 convs round a few outputs one unit apart); BN parameters
    left in f32 would put it at 6.2e-3."""
    s = bf16_slice
    name = "layer1.0.conv1"
    assert _rel(s["te"].state[name]["a"], s["je"].state[name]["a"]) <= 2e-3


def test_bf16_slice_g_factors(bf16_slice):
    """fc's bf16 G within 2e-2 of max of JAX's and of the port's f32 one.
    The conv layers' G is reached by the bf16 backward through batch-
    statistics BN at 32-512 positions per channel, which both packages
    round far beyond 2e-2 (JAX's own bf16 G is 8-31% of max from its f32
    G); there the port's bf16 error against the f32 G is held to at most
    twice JAX's, which a wrong cast or scale would exceed."""
    s = bf16_slice
    g, g32 = s["te"].state["fc"]["g"], s["te32"].state["fc"]["g"].numpy()
    assert _rel(g, s["je"].state["fc"]["g"]) <= BF16_RTOL
    assert _rel(g, g32) <= BF16_RTOL
    for name in s["je"].metas:
        g = s["te"].state[name]["g"]
        assert torch.isfinite(g).all(), name
        jax_err = _rel(np.asarray(s["je"].state[name]["g"]),
                       s["je32"].state[name]["g"])
        assert _rel(g, s["je32"].state[name]["g"]) <= 2 * jax_err + 1e-3, \
            name


def test_bf16_capture_leaves_the_model_alone(bf16_slice):
    """The capture runs on a bf16 copy of every float parameter (BN scale
    and bias included, as JAX's cast_floats): acts, probe gradients and
    logits in bf16; the model's own parameters and BN running buffers
    stay f32 and unchanged."""
    te, tm = bf16_slice["te"], bf16_slice["m"]["tm"]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    cap = te.capture(_nchw(bf16_slice["m"]["x"]),
                     labels=torch.tensor([[3, 7]]))
    assert cap.logits.dtype == torch.bfloat16
    for name in te.metas:
        assert cap.acts[name].dtype == torch.bfloat16, name
        assert cap.probe_grads[name].dtype == torch.bfloat16, name
    for k, v in tm.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k


def test_cast_helpers_match_jax():
    """cast_floats casts the floating leaves only; cast_input leaves an
    integer input alone; None is the identity (utils/casting.py)."""
    params = {"w": np.linspace(-1, 1, 7, dtype=np.float32) / 3,
              "idx": np.arange(3, dtype=np.int32)}
    want = jcasting.cast_floats({k: jnp.asarray(v)
                                 for k, v in params.items()}, jnp.bfloat16)
    got = cast_floats({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(want["w"], np.float32))
    assert got["idx"].dtype == torch.int32
    assert cast_floats(got, None) is got
    ids = torch.arange(4)
    assert cast_input(ids, torch.bfloat16) is ids
    assert cast_input(torch.zeros(2), torch.bfloat16).dtype == torch.bfloat16
    assert cast_input(ids, None) is ids
