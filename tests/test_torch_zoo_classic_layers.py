"""The classic families of the zoo in the port against the JAX package,
by shapes alone, and the pools they brought in (the numbers are
tests/test_torch_zoo_classic.py's).

Every registered name of DenseNet, VGG (with and without BatchNorm),
AlexNet, SqueezeNet, GoogLeNet, Inception v3 and the MLP is built by
``models.build`` on the meta device and held to JAX's abstract ``init``
(state-dict keys and shapes, the tracked layers' order; no weights, no
FLOPs); every conv's A-factor route at chip_smoke.py's zoo shapes
(DenseNet-121 at 224², B=16 and at the CIFAR CLI's 32², B=32; each
family at B=8) against JAX's gates; VGG-16's 25,089-wide A factor
against KFAC's bound; ``MaxPool`` with 'SAME' and ``ceil_mode``,
``AvgPool`` and the adaptive pools against JAX's layers at odd and tiny
extents.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu import nn as jnn
from curvature_tpu.ops.pallas.patch_gram import select_patch_gram
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.nn import Context

# the modules (each package's ``models`` exports a function ``vgg``)
jvgg = importlib.import_module("curvature_tpu.models.vgg")
tvgg = importlib.import_module("curvature_tpu_torch.models.vgg")

torch.set_num_threads(2)


# -- every registered name: parameters against JAX's init --------------------

NAMES = ["densenet121", "densenet161", "densenet169", "densenet201",
         "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
         "vgg16_bn", "vgg19_bn", "alexnet", "squeezenet1_0",
         "squeezenet1_1", "googlenet", "inception_v3", "mlp"]


def _jax_as_port_shapes(abstract):
    """JAX-layout abstract variables -> {port state-dict key: shape}, by
    ``models.state_dict_from_jax``'s rules on shapes alone."""
    out = {}
    for layer, p in abstract["params"].items():
        if "kernel" in p:
            k = p["kernel"].shape
            out[f"{layer}.weight"] = ((k[3], k[2], k[0], k[1])
                                      if len(k) == 4 else k[::-1])
            if "bias" in p:
                out[f"{layer}.bias"] = p["bias"].shape
        else:
            out[f"{layer}.weight"] = p["scale"].shape
            out[f"{layer}.bias"] = p["bias"].shape
    for layer, s in abstract.get("batch_stats", {}).items():
        out[f"{layer}.running_mean"] = s["mean"].shape
        out[f"{layer}.running_var"] = s["var"].shape
    return out


@pytest.mark.parametrize("name", NAMES)
def test_registered_names_match_jax_init(name):
    """``models.build`` makes every registered name of these families, at
    1000 classes, with JAX's parameters: the same state-dict keys and
    shapes (the port's model on the meta device, JAX's ``init`` traced
    abstractly: no weights, no FLOPs). Inception v3 at 299², the others
    at 224², the MLP on 13 inputs."""
    kw = {"in_features": 13} if name == "mlp" else {}
    with torch.device("meta"):
        tm = tmodels.build(name, 1000, device="meta", **kw)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    jm = jmodels.build(name, 1000)
    size = 299 if name == "inception_v3" else 224
    shape = (1, 13) if name == "mlp" else (1, size, size, 3)
    abstract = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32)))
    assert got == _jax_as_port_shapes(abstract)
    assert list(tm.metas) == list(jm.metas)


def test_unknown_and_unported_names():
    with pytest.raises(ValueError, match="unknown model"):
        tmodels.build("densenet122", 10, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        tmodels.build("gpt2_moe_tiny", 10, device="cpu")
    with pytest.raises(TypeError):
        tmodels.build("mlp", 10, device="cpu")          # no in_features


# -- A-factor routes: where the Gram kernels run ----------------------------

def _jax_route(je, meta, shape, itemsize):
    """JAX's A-factor route (kfac.py:363-400) for a non-grouped layer:
    the correlation gate, then ``select_patch_gram`` for explicit
    paddings under ``use_pallas``."""
    act = np.empty(shape, np.float32)
    if je._corr_gram_ok(meta, act):
        return "corr"
    if (je.use_pallas and meta.kind == "conv" and je.token_subsample >= 1.0
            and not isinstance(meta.padding, str)):
        return select_patch_gram(shape[-1], meta.kernel_size, meta.strides,
                                 shape[1], shape[2], shape[0],
                                 itemsize) or "patches"
    return "patches"


@pytest.fixture(scope="module")
def jax_gates():
    """A JAX KFAC with ``use_pallas=True`` and its default gates, whose
    route predicates read only a layer's meta and input shape: built once,
    on LeNet-5."""
    jm = jmodels.build("lenet5", 10)
    abstract = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1), jnp.float32)))
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   abstract)
    return jest.KFAC(jm, zeros, use_pallas=True)


#: (model, classes, batch, size) -> (tiled, v2) A routes per update, f32
#: then bf16: chip_smoke.py's zoo phase asserts the f32 counts as launches
#: (ZOO_ROUTES); in bf16 only Inception v3's stride-2 3x3 over 96 channels
#: (Mixed_6a) takes a kernel (v2)
ROUTE_CASES = {("densenet121", 1000, 16, 224): ((16, 0), (0, 0)),
               ("densenet121", 10, 32, 32): ((58, 0), (0, 0)),
               ("vgg16", 1000, 16, 224): ((2, 0), (0, 0)),
               ("densenet161", 1000, 8, 224): ((0, 0), (0, 0)),
               ("vgg16", 1000, 8, 224): ((2, 0), (0, 0)),
               ("inception_v3", 1000, 8, 299): ((10, 27), (0, 1)),
               ("googlenet", 1000, 8, 224): ((9, 0), (0, 0)),
               ("alexnet", 1000, 8, 224): ((0, 0), (0, 0)),
               ("squeezenet1_1", 1000, 8, 224): ((6, 0), (0, 0))}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_routes_match_jax(case, jax_gates):
    """Every tracked layer's route, f32 and bf16: the port's
    ``KFAC.a_route`` on the input shapes of a meta-device forward equals
    JAX's gates on the shapes of an abstract capture. f32 DenseNet-121
    takes the tiled kernel on denseblock4's 3x3 convs at 224² (C=128,
    7x7) and on 58 3x3 convs at 32² (extents 8, 4, 2 and 1), VGG-16 on
    ``features.2`` and ``features.5``, Inception v3 the v2 kernel on its
    1x7, 7x1, 1x3 and 3x1 convs too. The f32 counts are chip_smoke.py's
    ``ZOO_ROUTES``."""
    name, classes, batch, size = case
    with torch.device("meta"):
        tm = tmodels.build(name, classes, device="meta")
    te = port_est.KFAC(tm, use_kernels=True, max_factor_dim=1 << 15)
    ctx = Context(track=te.metas, probes=False)
    tm.eval()
    tm(torch.empty((batch, 3, size, size), device="meta"), ctx)
    jm = jmodels.build(name, classes)
    abstract = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)))
    acts = jax.eval_shape(
        lambda v, x: jm.apply(v, x, capture=True)[1]["acts"], abstract,
        jax.ShapeDtypeStruct((batch, size, size, 3), jnp.float32))
    for itemsize, expect in zip((4, 2), ROUTE_CASES[case]):
        got = {n: te.a_route(m, ctx.acts[n].shape, itemsize)
               for n, m in te.metas.items()}
        want = {n: _jax_route(jax_gates, m, acts[n].shape, itemsize)
                for n, m in jm.metas.items()}
        assert got == want, itemsize
        counts = tuple(list(got.values()).count(r) for r in ("tiled", "v2"))
        assert counts == expect, itemsize
        if case == ("densenet121", 1000, 16, 224) and itemsize == 4:
            assert {n for n, r in got.items() if r == "tiled"} == {
                f"features.denseblock4.denselayer{i}.conv2"
                for i in range(1, 17)}


def test_vgg16_classifier_is_past_the_default_factor_bound():
    """``classifier.0``'s A factor is 25,089 wide: KFAC raises at its
    default ``max_factor_dim`` (16,384), as JAX does, and builds it when
    the bound is raised (on the meta device: no 2.5 GB allocation)."""
    with torch.device("meta"):
        tm = tmodels.build("vgg16", 1000, device="meta")
        with pytest.raises(ValueError, match="classifier.0.*25089"):
            port_est.KFAC(tm)
        est = port_est.KFAC(tm, max_factor_dim=25089)
    assert tuple(est.state["classifier.0"]["a"].shape) == (25089, 25089)


# -- the pools ---------------------------------------------------------------

def _jax_layer(layer, x):
    """A JAX layer applied alone (a parameter-free model)."""
    jm = jnn.Model(jnn.Sequential([layer]))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return np.asarray(jm.apply(v, jnp.asarray(x))[0])


POOLS = [
    # (port layer, JAX layer, extents)
    ("maxpool 3/2 SAME", lambda: tnn.MaxPool(3, 2, padding="SAME"),
     lambda: jnn.MaxPool(3, 2, padding="SAME"), range(1, 10)),
    ("maxpool 2/2 SAME", lambda: tnn.MaxPool(2, 2, padding="SAME"),
     lambda: jnn.MaxPool(2, 2, padding="SAME"), range(1, 8)),
    ("maxpool 3/1 pad 1", lambda: tnn.MaxPool(3, 1, padding=1),
     lambda: jnn.MaxPool(3, 1, padding=1), range(1, 6)),
    ("maxpool 3/2 ceil_mode", lambda: tnn.MaxPool(3, 2, ceil_mode=True),
     lambda: jnn.MaxPool(3, 2, padding=0, ceil_mode=True), range(3, 16)),
    ("maxpool 3/2 pad 1 ceil_mode",
     lambda: tnn.MaxPool(3, 2, padding=1, ceil_mode=True),
     lambda: jnn.MaxPool(3, 2, padding=1, ceil_mode=True), range(1, 12)),
    ("avgpool 3/1 pad 1", lambda: tnn.AvgPool(3, 1, padding=1),
     lambda: jnn.AvgPool(3, 1, padding=1), range(1, 8)),
    ("avgpool 2/2", lambda: tnn.AvgPool(2, 2), lambda: jnn.AvgPool(2, 2),
     range(2, 8)),
    ("adaptive 6", lambda: tnn.AdaptiveAvgPool(6),
     lambda: jnn.AdaptiveAvgPool(6), range(1, 14)),
    ("adaptive 7 (VGG)", tvgg.AdaptiveAvgPool7, jvgg.AdaptiveAvgPool7,
     (1, 2, 3, 5, 6, 7, 8, 13, 14, 21)),
]


@pytest.mark.parametrize("what,port,jax_layer,extents", POOLS,
                         ids=[p[0] for p in POOLS])
def test_pools_match_jax(what, port, jax_layer, extents):
    """Output shapes and values equal JAX's at every extent listed, square
    and h != w (torch's own ``ceil_mode`` and ``adaptive_avg_pool2d``
    are not what JAX computes: the port carries JAX's arithmetic)."""
    rng = np.random.default_rng(3)
    for h in extents:
        for w in sorted({h, h + 1}):
            x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
            want = _jax_layer(jax_layer(), x)
            got = port()(torch.from_numpy(np.ascontiguousarray(
                x.transpose(0, 3, 1, 2)))).permute(0, 2, 3, 1).numpy()
            assert got.shape == want.shape, (what, h, w)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{what} {h}x{w}")


def test_adaptive7_is_not_torchs_adaptive_pool():
    """At a 2x2 map JAX's (and so the port's) 7x7 pool repeats, where
    ``F.adaptive_avg_pool2d`` averages overlapping bins."""
    x = torch.arange(8.0).reshape(1, 2, 2, 2)
    ours = tvgg.AdaptiveAvgPool7()(x)
    theirs = torch.nn.functional.adaptive_avg_pool2d(x, 7)
    assert ours.shape == theirs.shape == (1, 2, 7, 7)
    assert not torch.equal(ours, theirs)
    rep = x.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
    assert torch.equal(ours, rep[:, :, :7, :7])
