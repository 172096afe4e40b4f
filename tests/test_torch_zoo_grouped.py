"""The grouped-conv families of the zoo in the port against the JAX
package: ResNeXt / Wide ResNet, MobileNetV2/V3, EfficientNet, ShuffleNetV2,
RegNet, MNASNet and ConvNeXt.

Each family's port is built by JAX's registry name, given numpy-seeded
weights (``models.seeded_variables``) that both packages load, and held
to JAX on eval-mode logits at 32², 10 classes; the KFAC factors of one
update of ``efficientnet_b0`` and ``resnext50_32x4d`` on one stage each
(grouped, depthwise, SE and 1x1 layers) with injected MC labels; every
conv's A-factor route at the 224², B=16 shapes of ``chip_smoke.py``'s
grouped phase against JAX's gates (shapes only: a meta-device forward in
the port, an abstract trace in JAX); and a grouped factor file written by
one package's ``factors`` CLI read by the other's. ``cuda``-marked tests
count the Gram-kernel launches of a grouped update on the card (none, by
JAX's routes); they skip where there is no CUDA device.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.ops.pallas.patch_gram import select_patch_gram
from curvature_tpu.pipelines import evaluate as jevaluate
from curvature_tpu.pipelines import factors as jfactors
from curvature_tpu.utils import checkpoint as jckpt
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.nn import Context
from curvature_tpu_torch.pipelines import evaluate as tevaluate
from curvature_tpu_torch.pipelines import factors as tfactors
from curvature_tpu_torch.utils import checkpoint as tckpt
from curvature_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

#: one member of each new family (ResNeXt with the CIFAR stem at 32²)
FAMILIES = ["resnext50_32x4d", "wide_resnet50_2", "mobilenet_v2",
            "mobilenet_v3_small", "efficientnet_b0", "shufflenet_v2_x0_5",
            "regnet_y_400mf", "mnasnet0_5", "convnext_tiny"]
#: the models of chip_smoke.py's grouped phase: their updates at 224²,
#: B=16 must launch no Gram kernel
CHIP_MODELS = ("resnext50_32x4d", "efficientnet_b0", "convnext_tiny",
               "mobilenet_v2")


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _kw(name):
    return {"stem": "cifar"} if name.startswith("resnext") else {}


def _pair(name, x_shape=(2, 32, 32, 3), seed=0, residual_gain=0.2):
    """The port's model and JAX's, by registry name, with the same seeded
    weights (10 classes)."""
    tm = tmodels.build(name, 10, device="cpu", **_kw(name))
    variables = tmodels.seeded_variables(tm, seed, residual_gain)
    tmodels.load_jax_variables(tm, variables)
    jm = jmodels.build(name, 10, **_kw(name))
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros(x_shape, jnp.float32)))
    return tm, jm, jax.tree_util.tree_map(jnp.asarray, variables)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_gates():
    """A JAX KFAC with ``use_pallas=True`` and its default gates, whose
    route predicates read only a layer's meta and input shape: built once,
    on LeNet-5."""
    jm = jmodels.build("lenet5", 10)
    return jest.KFAC(jm, _zero_variables(jm, (1, 28, 28, 1)),
                     use_pallas=True)


def _zero_variables(jm, x_shape=(1, 32, 32, 3)):
    """JAX variables of the registry's shapes, all zeros, from an abstract
    ``init`` (no FLOPs): for what depends on shapes only."""
    abstract = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32)))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  abstract)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_logits_match_jax(name):
    """Every tracked layer's meta (name, order, shape, groups, padding)
    equals JAX's, and the eval-mode logits agree within 1e-5 of max: the
    same f32 convs, BN (EfficientNet's eps, MobileNetV3's Hardsigmoid
    gates), LayerNorms and layer scales."""
    tm, jm, jv = _pair(name)
    assert list(tm.metas) == list(jm.metas)
    for layer, m in jm.metas.items():
        t = tm.metas[layer]
        assert (t.kind, t.out_features, t.fan_in, t.has_bias, t.groups,
                tuple(t.kernel_size), tuple(t.strides), t.padding) == \
            (m.kind, m.out_features, m.fan_in, m.has_bias, m.groups,
             tuple(m.kernel_size), tuple(m.strides), m.padding), layer
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)) \
        .astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x)[0])(jv, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(_nchw(x))
    _close(got, want, 1e-5, name)


@pytest.mark.parametrize("name,stage", [
    ("efficientnet_b0", "features.2.*"),
    ("resnext50_32x4d", "layer4.2.*")])
def test_family_kfac_factors_match_jax(name, stage):
    """One KFAC update's factors on one stage (``layer_filter``), B=4,
    64², two injected MC label draws: EfficientNet-B0's second stage
    (expand 1x1, depthwise 3x3 at stride 2 and 1, SE fc1/fc2, project),
    ResNeXt-50's last block (1x1, grouped 3x3 of 32 groups of 288
    columns, 1x1); 1e-4 of max, the bar of tests/test_torch_kfac.py.
    ResNeXt's earlier G factors pass back through layer4's
    batch-statistics BN over 4 x 4 x 4 values per channel, whose backward
    cancels most of its input and so multiplies either package's f32
    rounding (4e-4 of max at layer1.0, 1.5e-2 at layer4.0, measured on
    the CPU; 5e-6 at layer4.2)."""
    tm, jm, jv = _pair(name, (4, 64, 64, 3))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(2, 4)).astype(np.int32)
    je = jest.KFAC(jm, jv, use_pallas=False, layer_filter=stage)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    te = port_est.KFAC(tm, layer_filter=stage)
    te.update(_nchw(x), labels=torch.from_numpy(labels))
    assert list(te.metas) == list(je.metas)
    assert any(m.groups > 1 for m in te.metas.values())
    for layer in je.metas:
        for key in "ag":
            _close(te.state[layer][key], je.state[layer][key], 1e-4,
                   f"{layer} {key}")


def _jax_route(je, meta, shape, itemsize):
    """JAX's A-factor route (kfac.py:363-400): a grouped conv's batched
    per-group Gram (the correlation Gram under ``corr_gram_grouped``)
    before anything else, then the correlation gate, then
    ``select_patch_gram`` for explicit paddings under ``use_pallas``."""
    act = np.empty(shape, np.float32)
    if je._is_grouped(meta):
        return ("corr" if je.corr_gram_grouped
                and je._corr_gram_ok(meta, act) else "grouped")
    if je._corr_gram_ok(meta, act):
        return "corr"
    if (je.use_pallas and meta.kind == "conv" and je.token_subsample >= 1.0
            and not isinstance(meta.padding, str)):
        return select_patch_gram(shape[-1], meta.kernel_size, meta.strides,
                                 shape[1], shape[2], shape[0],
                                 itemsize) or "patches"
    return "patches"


@pytest.mark.parametrize("name", FAMILIES)
def test_family_routes_at_224_match_jax(name, jax_gates):
    """Every tracked layer's route at 224², B=16 (ResNeXt with its
    ImageNet stem), f32 and bf16: the port's ``KFAC.a_route`` on the input
    shapes of a meta-device forward equals JAX's gates on the shapes of an
    abstract capture (no FLOPs, no compile). The grouped phase's models
    take no kernel route: chip_smoke.py asserts zero launches on them."""
    shape = (16, 224, 224, 3)
    with torch.device("meta"):
        tm = tmodels.build(name, 1000, device="meta")
    te = port_est.KFAC(tm, use_kernels=True)
    ctx = Context(track=te.metas, probes=False)
    tm.eval()
    tm(torch.empty((16, 3, 224, 224), device="meta"), ctx)
    jm = jmodels.build(name, 1000)
    jv = _zero_variables(jm)
    acts = jax.eval_shape(
        lambda x: jm.apply(jv, x, capture=True)[1]["acts"],
        jax.ShapeDtypeStruct(shape, jnp.float32))
    for itemsize in (4, 2):
        got = {n: te.a_route(m, ctx.acts[n].shape, itemsize)
               for n, m in te.metas.items()}
        want = {n: _jax_route(jax_gates, m, acts[n].shape, itemsize)
                for n, m in jm.metas.items()}
        assert got == want, itemsize
        assert all(got[n] == "grouped" for n, m in te.metas.items()
                   if m.groups > 1)
        if name in CHIP_MODELS:
            assert not {"tiled", "v2"} & set(got.values()), got


# -- the factors CLI: a grouped factor file in both packages -----------------

#: mobilenet_v2 on synthetic data (512 images in 2 batches), one MC draw,
#: two stages (depthwise convs of 96 and 144 channels, 1x1s)
CLI_ARGV = ["--platform", "cpu", "--model", "mobilenet_v2", "--data",
            "synthetic", "--batch_size", "256", "--mc_samples", "1",
            "--layers", "features.2.*,features.3.*", "--estimator", "kfac"]


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """The same seeded weights under ``<root>/weights`` (both packages
    load a JAX-layout npz there first); the port's ``factors`` CLI and
    JAX's, each in its own root."""
    roots = {k: str(tmp_path_factory.mktemp(k)) for k in ("port", "jax")}
    tm = tmodels.build("mobilenet_v2", 10, device="cpu")
    variables = tmodels.seeded_variables(tm, 0)
    for root in roots.values():
        os.makedirs(os.path.join(root, "weights"))
        tckpt.save_pytree(os.path.join(
            root, "weights", "mobilenet_v2_synthetic.npz"), variables)
    argv = {k: CLI_ARGV + ["--root_dir", r, "--results_dir", r]
            for k, r in roots.items()}
    tfactors.main(argv["port"])
    jfactors.main(argv["jax"])
    return argv


def test_grouped_factor_files_swap_between_the_packages(cli_files):
    """The port's file loads in JAX's ``load_estimator`` and JAX's in the
    port's, each as the writer's arrays bit for bit, with the depthwise
    layers' per-group [g, 9, 9] A and [g, 1, 1] G; the two files' A
    factors (no labels in them) within 1e-4 of max (tests/
    test_torch_kfac.py's bar: batch-statistics BN and sums over 131,072
    tokens in f32 in either package), their G traces within 20% (the MC
    labels differ), every invert finite."""
    t = tconfig.parse_args(cli_files["port"])
    j = jconfig.parse_args(cli_files["jax"])
    t_file = tckpt.load_pytree(tckpt.factors_path(t))
    j_file = jckpt.load_pytree(jckpt.factors_path(j))
    assert sorted(t_file) == sorted(j_file)
    tm = tmodels.build("mobilenet_v2", 10, device="cpu")
    jm = jmodels.build("mobilenet_v2", 10)
    jv = _zero_variables(jm)
    # the port's file read by JAX, JAX's by the port (roots swapped)
    in_jax = jevaluate.load_estimator(jconfig.parse_args(cli_files["port"]),
                                      jm, jv)
    in_port = tevaluate.load_estimator(tconfig.parse_args(
        cli_files["jax"]), tm)
    dw = "features.2.conv.1.0"
    assert in_port.metas[dw].groups == 96
    assert tuple(in_port.state[dw]["a"].shape) == (96, 9, 9)
    assert tuple(in_port.state[dw]["g"].shape) == (96, 1, 1)
    for name in j_file:
        for key in "ag":
            np.testing.assert_array_equal(np.asarray(in_jax.state[name][key]),
                                          t_file[name][key])
            np.testing.assert_array_equal(_np(in_port.state[name][key]),
                                          j_file[name][key])
        _close(t_file[name]["a"], j_file[name]["a"], 1e-4, name)
        tr = [float(np.trace(f[name]["g"], axis1=-2, axis2=-1).sum())
              for f in (t_file, j_file)]
        assert abs(tr[0] - tr[1]) <= 0.2 * tr[1], (name, tr)
    in_port.invert(1.0, 1e4)
    in_jax.invert(1.0, 1e4)
    for est in (in_port, in_jax):
        for inv in est.inv_state.values():
            for v in inv.values():
                assert np.isfinite(_np(v)).all()


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnext50_32x4d", "efficientnet_b0"])
def test_cuda_grouped_update_launches_no_gram_kernel(name):
    """A KFAC update of the grouped families at 224², B=2 on the card
    launches none of the Gram kernels (JAX's routes), with finite
    factors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from curvature_tpu_torch.ops.cuda import patch_gram as tpg
    from curvature_tpu_torch.ops.cuda import sym_gram as tsg
    model = tmodels.build(name, 1000, device="cuda")
    tmodels.load_jax_variables(model, tmodels.seeded_variables(model, 0))
    est = port_est.KFAC(model)
    assert est.use_kernels
    fns = (tpg.patch_gram_tiled, tpg.patch_gram_v2, tpg.patch_gram,
           tsg.sym_gram)
    before = [f.launches for f in fns]
    x = torch.randn((2, 3, 224, 224), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    est.update(x, generator=torch.Generator("cuda").manual_seed(1))
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == before
    for fac in est.state.values():
        assert all(torch.isfinite(v).all() for v in fac.values())
