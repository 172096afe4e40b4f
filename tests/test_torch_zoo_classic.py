"""The classic families of the zoo in the port against the JAX package:
DenseNet, VGG (with and without BatchNorm), AlexNet, SqueezeNet 1.0/1.1,
GoogLeNet, Inception v3 and the MLP, and the pools they brought in.

Each family is built in both packages (narrow custom configurations where
the family has one: ``DenseNet(8, (2, 2), 16)``, a two-stage VGG), given
numpy-seeded weights (``models.seeded_variables``) that both load, and
held to JAX on eval-mode logits (1e-5 of max|logit|) and on the KFAC
factors of one update with injected MC labels (1e-4 of max in f32, the
bar of tests/test_torch_kfac.py; GoogLeNet and Inception v3 in float64).
tests/test_torch_zoo_classic_layers.py holds every registered name's
parameters, the A-factor routes and the pools. ``cuda``-marked tests run
the tiled kernel at DenseNet's small extents on the card.
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
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.utils.device import resolve_device
from tests.torch_float64 import float64, to_float64

# the modules (each package's ``models`` exports functions of these names)
jdensenet = importlib.import_module("curvature_tpu.models.densenet")
jvgg = importlib.import_module("curvature_tpu.models.vgg")
tdensenet = importlib.import_module("curvature_tpu_torch.models.densenet")
tvgg = importlib.import_module("curvature_tpu_torch.models.vgg")

torch.set_num_threads(2)

#: the narrow VGG of these tests: two stages, eight and sixteen channels
VGG_NARROW = [8, "M", 16, 16, "M"]


def _narrow(name, monkeypatch):
    """(port model, JAX model) of a test family, 10 classes, on the CPU."""
    dev = resolve_device("cpu")
    if name == "densenet":
        return (tdensenet.DenseNet(8, (2, 2), 16, 10).to(dev),
                jnn.Model(jdensenet.DenseNet(8, (2, 2), 16, 10)))
    if name.startswith("vgg_narrow"):
        bn = name.endswith("_bn")
        monkeypatch.setitem(jvgg._CFGS, "vgg_narrow", VGG_NARROW)
        return (tvgg.VGG(VGG_NARROW, 10, bn).to(dev),
                jvgg.vgg("vgg_narrow", 10, bn))
    kw = {"in_features": 7} if name == "mlp" else {}
    return (tmodels.build(name, 10, device="cpu", **kw),
            jmodels.build(name, 10))


#: family -> the input the tests give it (NHWC; the MLP's [B, 7]): odd
#: extents where a pool rounds (SqueezeNet's ceil_mode, GoogLeNet's
#: 'SAME'), Inception's least, AlexNet's least but one
SHAPES = {"densenet": (2, 32, 32, 3), "vgg_narrow": (2, 32, 32, 3),
          "vgg_narrow_bn": (2, 32, 32, 3), "alexnet": (2, 64, 64, 3),
          "squeezenet1_0": (2, 35, 35, 3), "squeezenet1_1": (2, 33, 33, 3),
          "googlenet": (2, 35, 35, 3), "inception_v3": (2, 75, 75, 3),
          "mlp": (4, 7)}
FAMILIES = list(SHAPES)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _torch_input(x):
    x = np.ascontiguousarray(x.transpose(0, 3, 1, 2)) if x.ndim == 4 else x
    return torch.from_numpy(x)


def _pair(name, monkeypatch, seed=0):
    """The port's model and JAX's with the same seeded weights, and JAX's
    metas from an abstract ``init``."""
    tm, jm = _narrow(name, monkeypatch)
    variables = tmodels.seeded_variables(tm, seed)
    tmodels.load_jax_variables(tm, variables)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros(SHAPES[name], jnp.float32)))
    return tm, jm, jax.tree_util.tree_map(jnp.asarray, variables)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_logits_match_jax(name, monkeypatch):
    """Every tracked layer's meta (name, order, shape, padding) equals
    JAX's, and the eval-mode logits agree within 1e-5 of max: DenseNet's
    channel concatenation, VGG's 7x7 pool by repetition (a 1x1 map here),
    AlexNet's 6x6 adaptive bins, SqueezeNet's ceil_mode pools at 35² and
    33², GoogLeNet's 'SAME' pools at 35², Inception v3's 1x7/7x1 convs
    and border-counting average pools, BasicConv2d's BN eps 1e-3."""
    tm, jm, jv = _pair(name, monkeypatch)
    assert list(tm.metas) == list(jm.metas)
    for layer, m in jm.metas.items():
        t = tm.metas[layer]
        assert (t.kind, t.out_features, t.fan_in, t.has_bias,
                tuple(t.kernel_size), tuple(t.strides), t.padding) == \
            (m.kind, m.out_features, m.fan_in, m.has_bias,
             tuple(m.kernel_size), tuple(m.strides), m.padding), layer
    x = np.random.default_rng(1).standard_normal(SHAPES[name]) \
        .astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x)[0])(jv, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(_torch_input(x))
    _close(got, want, 1e-5, name)


#: family -> the layers whose factors are held in f32 (``layer_filter``):
#: all of the narrow ones, AlexNet's convs (past the dense layers'
#: 9,217-wide A factor). GoogLeNet and Inception v3 see 2x2 and 1x1 maps
#: in their last blocks at these sizes, where batch-statistics BN over 8 or
#: 2 values per channel multiplies either package's f32 rounding past the
#: bar (5e-3 of max on the A and 1e4 x the bar on the G factors, measured
#: on the CPU): they are held in float64 below
STAGES = {"densenet": None, "vgg_narrow_bn": None, "alexnet": "features.*",
          "squeezenet1_1": None, "mlp": None}


@pytest.mark.parametrize("name", list(STAGES))
def test_family_kfac_factors_match_jax(name, monkeypatch):
    """One KFAC update's A and G factors, B=2 (the MLP: B=4), two
    injected MC label draws, through ``models.state_from_jax``: within
    1e-4 of max. The A routes are the plain ones in both packages (no
    kernel on the CPU)."""
    tm, jm, jv = _pair(name, monkeypatch)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(SHAPES[name]).astype(np.float32)
    labels = rng.integers(0, 10, size=(2, x.shape[0])).astype(np.int32)
    stage = STAGES[name]
    je = jest.KFAC(jm, jv, use_pallas=False, layer_filter=stage)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    te = port_est.KFAC(tm, layer_filter=stage)
    te.update(_torch_input(x), labels=torch.from_numpy(labels))
    want = tmodels.state_from_jax(
        jax.tree_util.tree_map(np.asarray, je.state), "cpu")
    assert list(te.metas) == list(je.metas) and len(te.metas) >= 3
    for layer in je.metas:
        for key in "ag":
            _close(te.state[layer][key], want[layer][key], 1e-4,
                   f"{layer} {key}")


#: family -> (its last block, on a 2x2 or 1x1 map; the float64 bar, of
#: max). Over every layer, through up to 22 batch-statistics BNs, the CPU
#: measured 1.1e-9 for Inception v3 and 7.4e-12 for GoogLeNet
DEEP = {"googlenet": ("inception5b.*", 1e-10),
        "inception_v3": ("Mixed_7c.*", 1e-8)}


@pytest.mark.parametrize("name", list(DEEP))
def test_deep_family_kfac_factors_match_jax_in_float64(name, monkeypatch):
    """GoogLeNet's and Inception v3's last block: one KFAC update's
    factors, B=2, two injected MC label draws, both packages in float64
    (weights, input, factors, and both BatchNorms patched to compute in
    float64: tests/torch_float64.py), within ``DEEP``'s bar of max."""
    tm, jm, _ = _pair(name, monkeypatch)
    tm = tm.double()
    rng = np.random.default_rng(2)
    x = rng.standard_normal(SHAPES[name])
    labels = rng.integers(0, 10, size=(2, x.shape[0])).astype(np.int32)
    with float64(monkeypatch):
        jv = jax.tree_util.tree_map(jnp.asarray, to_float64(
            tmodels.variables_to_jax(tm)))
        stage, bar = DEEP[name]
        je = jest.KFAC(jm, jv, use_pallas=False, dtype=jnp.float64,
                       layer_filter=stage)
        je.update(jnp.asarray(x), labels=jnp.asarray(labels))
        te = port_est.KFAC(tm, dtype=torch.float64, layer_filter=stage)
        te.update(_torch_input(x), labels=torch.from_numpy(labels))
        want = jax.tree_util.tree_map(np.asarray, je.state)
    assert list(te.metas) == list(je.metas) and len(te.metas) >= 6
    for layer in je.metas:
        for key in "ag":
            assert te.state[layer][key].dtype == torch.float64
            _close(te.state[layer][key], want[layer][key], bar,
                   f"{layer} {key}")


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 7, 7, 128), (32, 2, 2, 128),
                                   (32, 1, 1, 128)])
def test_cuda_tiled_kernel_at_densenet_extents(shape):
    """The tiled f32 kernel against its plain version at DenseNet's
    shapes (3x3, pad 1): 7x7 at 224², and the CIFAR CLI's 2x2 and 1x1,
    where most window taps fall in the padding and the token count is
    under one chunk: 1e-4 of max|G|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from curvature_tpu_torch.ops.cuda import patch_gram as tpg
    x = torch.randn(shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    pad = ((1, 1), (1, 1))
    got = tpg.patch_gram_tiled(x, (3, 3), pad, (1, 1))
    want = tpg.patch_gram_plain(x, (3, 3), pad, (1, 1))
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
