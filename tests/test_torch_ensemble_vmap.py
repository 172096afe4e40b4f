"""The vmapped ensemble forwards of the port against the JAX package's.

One posterior ensemble of S=3 members (the model's seeded variables plus
numpy-seeded offsets on every parameter) is carried across by
``models/convert.py``: JAX's ``make_ensemble_fn`` takes it stacked on a
leading axis, the port's ``make_ensemble_fn`` takes the members' state
dicts and vmaps ``functional_call`` over them. Families: LeNet-5, a
CIFAR ResNet-18 and MobileNetV3-Small (BatchNorm in eval mode), a tiny
ViT, GPT-2 tiny and the Switch GPT-2 tiny (per-token [S, B*T, V]), and
the narrow MaxViT, the one family routed to a member loop by its class;
an ImageNet-stem ResNet-18 on images above ``VMAP_MAX_PIXELS``, routed
to the loop by their size. Then
``eval_bnn`` with ``stats``, the port's ``sample_chunk`` on a given
ensemble, and ``eval_bnn_linearized`` against JAX's on the same members.
Tolerances are relative to the max of the JAX value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import models as jmodels
from curvature_tpu.eval import evaluate as jeval
from curvature_tpu.eval import predictive as jpred
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.eval import evaluate as teval
from curvature_tpu_torch.eval import predictive as tpred

torch.set_num_threads(1)

S, CLASSES, RTOL = 3, 10, 1e-5
MAXVIT_SMALL = dict(stem_channels=8, block_channels=(8, 16),
                    block_layers=(1, 1), head_dim=4, partition=2)


def _close(got, want, rel, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _build(name):
    """(port model, JAX model, JAX-layout input) of a family."""
    rng = np.random.default_rng(7)
    if name == "lenet5":
        x = rng.standard_normal((4, 28, 28, 1))
        return (tmodels.lenet5(CLASSES, device="cpu"),
                jmodels.lenet5(CLASSES), x)
    if name == "resnet18":
        x = rng.standard_normal((4, 32, 32, 3))
        return (tmodels.resnet18(CLASSES, device="cpu"),
                jmodels.resnet18(CLASSES), x)
    if name == "mobilenet_v3_small":
        x = rng.standard_normal((2, 32, 32, 3))
        return (tmodels.mobilenet_v3_small(CLASSES, device="cpu"),
                jmodels.mobilenet_v3_small(CLASSES), x)
    if name == "vit":
        x = rng.standard_normal((2, 32, 32, 3))
        return (tmodels.vit(32, 8, 32, 2, 4, 64, CLASSES, device="cpu"),
                jmodels.vit(32, 8, 32, 2, 4, 64, CLASSES), x)
    if name == "maxvit_small":
        x = rng.standard_normal((2, 64, 64, 3))
        return (tmodels.maxvit(**MAXVIT_SMALL, num_classes=CLASSES,
                               device="cpu"),
                jmodels.maxvit(**MAXVIT_SMALL, num_classes=CLASSES), x)
    x = rng.integers(0, 32, (2, 8))
    if name == "gpt2_tiny":
        return (tmodels.gpt2_tiny(32, max_len=8, device="cpu"),
                jmodels.gpt2_tiny(32, max_len=8), x)
    return (tmodels.gpt2_moe_tiny(32, experts=4, max_len=8, device="cpu"),
            jmodels.gpt2_moe_tiny(32, experts=4, max_len=8), x)


def _inputs(x):
    """(JAX input, port input): images NHWC -> NCHW; tokens as they are."""
    if x.ndim == 4:
        x = x.astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    x = x.astype(np.int32)
    return jnp.asarray(x), torch.from_numpy(x).long()


def _ensemble(tm, variables, scale=0.02, seed=3):
    """(JAX params stacked [S, ...], the port members' state dicts: every
    parameter, and the float buffers that hold a JAX parameter)."""
    rng = np.random.default_rng(seed)
    def offset(path, v):
        # MaxViT's relative-position index is a table of indices
        if "index" in jax.tree_util.keystr(path) or \
                not np.issubdtype(v.dtype, np.floating):
            return v
        return (v + scale * np.abs(v).mean()
                * rng.standard_normal(v.shape)).astype(v.dtype)
    members = [jax.tree_util.tree_map_with_path(offset, variables["params"])
               for _ in range(S)]
    stacked = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *members)
    params, state = dict(tm.named_parameters()), tm.state_dict()
    port = []
    for p in members:
        sd = tmodels.state_dict_from_jax({"params": p})
        assert set(params) <= set(sd), set(params) - set(sd)
        port.append({k: v for k, v in sd.items()
                     if k in state and state[k].is_floating_point()})
    return stacked, port


FAMILIES = ("lenet5", "resnet18", "mobilenet_v3_small", "vit", "gpt2_tiny",
            "gpt2_moe_tiny", "maxvit_small")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    tm, jm, x = _build(request.param)
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    jx, tx = _inputs(x)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jx))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    stacked, port = _ensemble(tm, variables)
    return dict(name=request.param, tm=tm, jm=jm, jv=jv, jx=jx, tx=tx,
                stacked=stacked, port=port)


def test_ensemble_fn_matches_jax(family):
    """[S, B, K] (per token [S, B*T, V]) softmax of every member, one
    vmapped call, within 1e-5 of max of JAX's."""
    f = family
    want = jeval.make_ensemble_fn(f["jm"])(
        f["stacked"], f["jv"].get("batch_stats", {}), f["jx"])
    got = teval.make_ensemble_fn(f["tm"])(f["port"], f["tx"])
    _close(got, want, RTOL, f["name"])
    # stacked once, or given stacked: the same numbers
    st = teval.stack_ensemble(f["port"])
    np.testing.assert_array_equal(
        teval.make_ensemble_fn(f["tm"])(st, f["tx"]).numpy(), got.numpy())


def test_forward_fn_matches_jax(family):
    f = family
    want = jeval.make_forward_fn(f["jm"])(f["jv"], f["jx"])
    got = teval.make_forward_fn(f["tm"])(None, f["tx"])
    _close(got, want, RTOL, f["name"])


def test_routes_are_stated_per_family():
    """The route, decided before the call by the class and the image
    size: MaxViT never runs under vmap (its vmapped forward raises on the
    card, models/maxvit.py); the convolutional families run under vmap
    up to VMAP_MAX_PIXELS an image and loop above it (cuDNN's grouped
    convolution is slower than the loop at 224² on the card), a
    CIFAR-stem ResNet up to 32²; ViT and Swin vmap at any size; token
    inputs always vmap."""
    assert tmodels.MaxVit.vmap_ensemble is False
    routed_away = {name for name in tmodels.MODEL_REGISTRY
                   if name.startswith("maxvit")}
    assert routed_away == {"maxvit_t"}
    assert not teval.vmaps(tmodels.MaxVit.__new__(tmodels.MaxVit))
    side = int(teval.VMAP_MAX_PIXELS ** 0.5)
    small, large = torch.empty(2, 3, 32, 32), torch.empty(2, 3, 224, 224)
    edge = torch.empty(2, 3, side, side)
    above = torch.empty(2, 3, side, side + 1)
    for cls in (tmodels.ResNet, tmodels.DenseNet, tmodels.VGG,
                tmodels.MobileNetV2, tmodels.MobileNetV3, tmodels.EfficientNet,
                tmodels.ConvNeXt, tmodels.RegNet, tmodels.ShuffleNetV2,
                tmodels.MNASNet, tmodels.SqueezeNet, tmodels.GoogLeNet,
                tmodels.InceptionV3, tmodels.AlexNet):
        m = cls.__new__(cls)
        assert teval.vmaps(m) and teval.vmaps(m, small), cls.__name__
        assert teval.vmaps(m, edge), cls.__name__
        assert not teval.vmaps(m, above), cls.__name__
        assert not teval.vmaps(m, large), cls.__name__
    cifar = tmodels.resnet18(CLASSES, device="cpu")
    assert teval.vmaps(cifar, small)
    assert not teval.vmaps(cifar, torch.empty(2, 3, 32, 33))
    assert teval.vmaps(tmodels.resnet18(CLASSES, stem="imagenet",
                                        device="cpu"), edge)
    for cls in (tmodels.VisionTransformer, tmodels.SwinTransformer):
        assert teval.vmaps(cls.__new__(cls), large), cls.__name__
    for cls in (tmodels.GPT2, tmodels.TinyTransformer, tmodels.Encoder):
        m = cls.__new__(cls)
        assert teval.vmaps(m, torch.empty(2, 512, dtype=torch.long)), \
            cls.__name__


def test_large_images_take_the_member_loop():
    """An ImageNet-stem ResNet-18 on images above VMAP_MAX_PIXELS: the
    ensemble is prepared as a member list (no stacked copy) and loops;
    its [S, B, K] matches JAX's vmapped one within 1e-5 of max, and the
    vmap route forced on the instance gives the same numbers."""
    side = int(teval.VMAP_MAX_PIXELS ** 0.5) + 8
    tm = tmodels.resnet18(CLASSES, stem="imagenet", device="cpu")
    jm = jmodels.resnet18(CLASSES, stem="imagenet")
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    x = np.random.default_rng(9).standard_normal((2, side, side, 3))
    jx, tx = _inputs(x)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jx))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    stacked, port = _ensemble(tm, variables)
    ens = teval.prepare_ensemble(tm, port, tx)
    assert isinstance(ens, list) and len(ens) == S
    assert all(e is p for e, p in zip(ens, port))
    want = jeval.make_ensemble_fn(jm)(stacked, jv["batch_stats"], jx)
    got = teval.make_ensemble_fn(tm)(port, tx)
    _close(got, want, RTOL, "loop route")
    tm.vmap_max_pixels = None
    try:
        assert isinstance(teval.prepare_ensemble(tm, port, tx),
                          teval.StackedEnsemble)
        forced = teval.make_ensemble_fn(tm)(port, tx)
    finally:
        del tm.vmap_max_pixels
    _close(forced, got.numpy(), RTOL, "vmap route")


@pytest.fixture(scope="module")
def r18():
    tm, jm, x = _build("resnet18")
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    rng = np.random.default_rng(11)
    data = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, CLASSES, 4)) for _ in range(2)]
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.asarray(data[0][0])))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    stacked, port = _ensemble(tm, variables, scale=0.2)
    nchw = [(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
             y) for x, y in data]
    return dict(tm=tm, jm=jm, jv=jv, data=data, nchw=nchw, stacked=stacked,
                port=port, variables=variables)


def test_eval_bnn_stats_matches_jax(r18):
    """Mean predictions and the running statistics (accuracy and ECE in
    percent, per-sample NLL, entropy) of the same ensemble: 1e-5 / 1e-4."""
    r = r18
    want_p, want_y, want = jeval.eval_bnn(
        r["jm"], r["jv"], None, r["data"], S, stats=True,
        ensemble_params=r["stacked"])
    got_p, got_y, got = teval.eval_bnn(r["tm"], None, r["nchw"], S,
                                       ensemble_params=r["port"], stats=True)
    np.testing.assert_array_equal(got_y, want_y)
    _close(got_p, want_p, RTOL, "mean predictions")
    assert sorted(got) == sorted(want)
    for k in want:
        _close(np.asarray(got[k]), np.asarray(want[k]), 1e-4, k)


@pytest.mark.parametrize("chunk", [1, 2])
def test_sample_chunk_matches_jax(r18, chunk):
    """A given ensemble run ``chunk`` members a vmapped call: JAX's
    unchunked mean predictions within 1e-5, the same running stats."""
    r = r18
    want_p, _, want = jeval.eval_bnn(r["jm"], r["jv"], None, r["data"], S,
                                     stats=True,
                                     ensemble_params=r["stacked"])
    got_p, _, got = teval.eval_bnn(r["tm"], None, r["nchw"], S,
                                   ensemble_params=r["port"], stats=True,
                                   sample_chunk=chunk)
    _close(got_p, want_p, RTOL, f"chunk {chunk}")
    for k in want:
        _close(np.asarray(got[k]), np.asarray(want[k]), 1e-4, k)


class _Fixed:
    """An estimator stand-in that hands out a given ensemble."""

    def __init__(self, mean_params, ensemble):
        self.mean_params, self.ensemble = mean_params, ensemble

    def ensemble_params(self, *args, **kwargs):
        return self.ensemble


@pytest.mark.parametrize("method", ["mc", "probit", "bridge"])
def test_eval_bnn_linearized_matches_jax(r18, method):
    """The GLM predictive of the same members around the same MAP: the
    port's vmapped jvp against JAX's, 1e-5 of max."""
    r = r18
    jmean = jax.tree_util.tree_map(jnp.asarray, r["variables"]["params"])
    want, want_y = jpred.eval_bnn_linearized(
        r["jm"], r["jv"], _Fixed(jmean, r["stacked"]), r["data"], S,
        method=method)
    tmean = {k: v.detach() for k, v in r["tm"].named_parameters()}
    got, got_y = tpred.eval_bnn_linearized(
        r["tm"], _Fixed(tmean, None), r["nchw"], S,
        ensemble_params=r["port"], method=method)
    np.testing.assert_array_equal(got_y, want_y)
    _close(got, want, RTOL, method)


def test_linearized_logits_match_jax(r18):
    r = r18
    jmean = jax.tree_util.tree_map(jnp.asarray, r["variables"]["params"])
    x = r["data"][0][0]
    want0, want = jpred.make_linearized_ensemble_fn(r["jm"])(
        jmean, r["stacked"], r["jv"]["batch_stats"], jnp.asarray(x))
    tmean = {k: v.detach() for k, v in r["tm"].named_parameters()}
    got0, got = tpred.make_linearized_ensemble_fn(r["tm"])(
        tmean, r["port"], r["nchw"][0][0])
    _close(got0, want0, RTOL, "MAP logits")
    _close(got, want, RTOL, "linearized logits")


def test_channels_last_model_enters_vmap_contiguous():
    """A channels_last model whose members replace one layer (as
    BlockDiagonal's do): every other 4-D weight reaches the vmapped call
    as a contiguous copy (``evaluate.nchw_rest``), and the vmapped
    softmax equals a member loop on the channels_last model."""
    from torch.func import functional_call
    torch.manual_seed(0)
    tm = tmodels.resnet18(CLASSES, device="cpu")
    tmodels.load_jax_variables(tm, tmodels.seeded_variables(tm, 0))
    tm = tm.to(memory_format=torch.channels_last).eval()
    x = torch.randn(2, 3, 32, 32).contiguous(
        memory_format=torch.channels_last)
    key = "layer1.0.conv1.weight"
    w = tm.get_parameter(key).detach()
    ens = [{key: w + 0.05 * torch.randn_like(w)} for _ in range(S)]
    rest = teval.nchw_rest(tm, ens[0])
    # every other conv weight, the 1x1 ones too: contiguous in both
    # formats, their channels_last strides still steer cuDNN's layout
    convs = {k for k, v in tm.named_parameters() if v.ndim == 4}
    assert set(rest) == convs - {key}
    for k, v in rest.items():
        assert v.stride() == v.contiguous(
            memory_format=torch.contiguous_format).clone().stride(), k
        assert tm.get_parameter(k).stride() != v.stride(), k
    got = teval.make_ensemble_fn(tm)(ens, x)
    with torch.no_grad():
        want = torch.stack([torch.softmax(functional_call(tm, e, (x,)), -1)
                            for e in ens])
    _close(got, want.numpy(), RTOL, "channels_last")
