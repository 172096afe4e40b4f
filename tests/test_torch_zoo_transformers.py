"""The JAX zoo's vision transformers in the port against the JAX package:
ViT (unrolled and depth-stacked), Swin v1 and v2, MaxViT; their
torchvision ``.pth`` checkpoints; the A-factor routes of MaxViT-T at 224²;
and the CLIs with ``--qkv_split``/``--head_split``.

Weights go into both packages through ``models.seeded_variables`` /
``models.convert`` (the raw ``"value"`` params and the index buffers
included), inputs are numpy-seeded, labels injected. Sizes are JAX
tests/test_models.py:493-680's: ViT at 32² with 8² patches (dim 32, depth
2, 4 heads), Swin-T at 56², Swin-V2-T at 48², MaxViT at 64² with
``partition=2`` (a narrow MaxViT for the factors, the full MaxViT-T for
the logits), 10 classes. Each test states its tolerance, relative to the
largest magnitude of the JAX value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu import nn as jnn
from curvature_tpu.models.swin import SwinTransformer as JSwin
from curvature_tpu.ops.pallas import select_patch_gram
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.eval.predictive import make_linearized_ensemble_fn
from curvature_tpu_torch.nn import Context
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.pipelines import evaluate as tevaluate
from curvature_tpu_torch.pipelines import factors as tfactors
from curvature_tpu_torch.utils import checkpoint as tckpt
from curvature_tpu_torch.utils import config as tconfig
from tests.torch_zoo import TorchMaxVit, TorchSwin, TorchSwinV2, TorchViT

torch.set_num_threads(1)

CLASSES = 10
#: the narrow MaxViT of the factor checks (JAX tests/test_models.py:647)
MAXVIT_SMALL = dict(stem_channels=8, block_channels=(8, 16),
                    block_layers=(1, 1), head_dim=4, partition=2)
#: a narrow Swin V2 (embed, depths, heads, window) whose every stage map at
#: 128² (32, 16, 8, 4) is a whole number of 4x4 windows: nothing pads
SWIN_V2_SMALL = (16, (2, 2, 2, 2), (2, 2, 4, 4), 4)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _jv(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _images(batch, size, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _build(name):
    """(port model, JAX model, input size) of a case."""
    if name in ("vit", "vit_scan"):
        scan = name == "vit_scan"
        return (tmodels.vit(32, 8, 32, 2, 4, 64, CLASSES, scan,
                            device="cpu"),
                jmodels.vit(32, 8, 32, 2, 4, 64, CLASSES, scan_blocks=scan),
                32)
    if name in ("swin_t", "swin_v2_t"):
        return (tmodels.build(name, CLASSES, device="cpu"),
                jmodels.build(name, CLASSES),
                56 if name == "swin_t" else 48)
    if name == "swin_v2_small":
        return (tmodels.SwinTransformer(*SWIN_V2_SMALL, CLASSES, v2=True),
                jnn.Model(JSwin(*SWIN_V2_SMALL, CLASSES, v2=True)),
                128)
    if name == "maxvit_small":
        return (tmodels.maxvit(**MAXVIT_SMALL, num_classes=CLASSES,
                               device="cpu"),
                jmodels.maxvit(**MAXVIT_SMALL, num_classes=CLASSES), 64)
    return (tmodels.maxvit_t(CLASSES, partition=2, device="cpu"),
            jmodels.maxvit_t(CLASSES, partition=2), 64)


def _pair(name, seed=0):
    tm, jm, size = _build(name)
    variables = tmodels.seeded_variables(tm, seed)
    tmodels.load_jax_variables(tm, variables)
    jvars = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)))
    return tm, jm, variables, jvars, size


CASES = ("vit", "vit_scan", "swin_t", "swin_v2_t", "swin_v2_small",
         "maxvit_small", "maxvit_t")


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    return (request.param,) + _pair(request.param)


def test_layers_and_variables_match_jax(pair):
    """The tracked layers in JAX's order with its metas (heads, stacks,
    groups), and every JAX variable with its shape (the ``"value"``
    params: class token, positional embedding, bias tables, logit scales,
    index and coordinate tables)."""
    name, tm, jm, variables, jvars, _ = pair
    assert list(tm.metas) == list(jm.metas)
    for n, m in jm.metas.items():
        t = tm.metas[n]
        assert (t.kind, t.out_features, t.fan_in, t.has_bias, t.stacked,
                t.heads, t.groups, t.kernel_size, t.strides) == \
            (m.kind, m.out_features, m.fan_in, m.has_bias, m.stacked,
             m.heads, m.groups, m.kernel_size, m.strides), n
    assert set(variables["params"]) == set(jvars["params"])
    for layer, group in jvars["params"].items():
        assert set(group) == set(variables["params"][layer]), layer
        for k, arr in group.items():
            assert variables["params"][layer][k].shape == arr.shape, \
                (layer, k)
    assert set(variables["batch_stats"]) == set(jvars.get("batch_stats",
                                                          {}))
    if name == "vit_scan":
        assert tm.scan_groups == jm.scan_groups
    again = tmodels.variables_to_jax(tm)
    for layer, group in variables["params"].items():
        for k, arr in group.items():
            np.testing.assert_array_equal(again["params"][layer][k], arr)


def test_logits_match_jax(pair):
    """Eval-mode logits within 1e-5 of max (MaxViT's BatchNorms on their
    running statistics)."""
    name, tm, jm, variables, _, size = pair
    x = _images(2, size, 1)
    want, _ = jm.apply(_jv(variables), jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(_nchw(x))
    _close(got, want, 1e-5, f"{name} logits")


@pytest.mark.parametrize("name,split", [
    ("vit", "attention_qkv_split"), ("vit_scan", "attention_head_split"),
    ("vit", None), ("swin_t", None), ("swin_v2_t", None),
    ("swin_v2_small", None), ("maxvit_small", None)])
def test_kfac_factors_match_jax(name, split):
    """One KFAC update (B=2, injected labels, MC=2) in each package: every
    factor within 1e-4 of max of JAX's, and the running statistics of
    MaxViT's BatchNorms untouched by the capture (equal to the bit).
    Where no window pads (``swin_v2_small``) JAX's Swin V2 qkv G is finite
    and held whole; at 48² see ``_v2_finite_pattern``."""
    tm, jm, variables, _, size = _pair(name, seed=3)
    x = _images(2, size, 4)
    labels = np.random.default_rng(5).integers(
        0, CLASSES, (2, 2)).astype(np.int32)
    kw = {split: True} if split else {}
    je = jest.KFAC(jm, _jv(variables), use_pallas=False, **kw)
    te = port_est.KFAC(tm, use_kernels=True, **kw)
    assert list(te.metas) == list(je.metas)
    stats = {k: v.clone() for k, v in tm.state_dict().items()
             if "running" in k}
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    te.update(_nchw(x), labels=torch.from_numpy(labels))
    for n in je.metas:
        assert set(te.state[n]) == set(je.state[n]), n
        for key in je.state[n]:
            want = np.asarray(je.state[n][key])
            got = _np(te.state[n][key])
            if name == "swin_v2_t" and n.endswith("attn.qkv") and key == "g":
                finite = _v2_finite_pattern(want, got)
                got, want = got[finite], want[finite]
            _close(got, want, 1e-4, f"{n} {key}")
    for k, v in stats.items():
        assert torch.equal(tm.state_dict()[k], v), k
    if name.startswith("maxvit"):
        assert stats


def _v2_finite_pattern(want, got):
    """Swin V2 zeroes the key bias, so a window's padding tokens have
    all-zero keys, and JAX differentiates ``jnp.linalg.norm`` at zero to
    NaN: its qkv G is NaN in exactly the key chunk's rows and columns
    wherever windows pad (48² pads every stage; so does 224² at the 28²
    stage). torch differentiates the norm at zero to 0, as torchvision's
    ``F.normalize`` does: the port's G is finite. Checks that pattern and
    returns the mask of JAX's finite entries, the only ones compared (the
    key chunk is held to JAX by ``swin_v2_small``, where nothing pads)."""
    c = want.shape[-1] // 3
    nan = np.isnan(want)
    key = np.zeros_like(nan)
    key[c:2 * c, :] = key[:, c:2 * c] = True
    assert nan.any() and (nan == key).all()
    assert np.isfinite(got).all()
    return ~nan


def test_scan_blocks_match_unrolled():
    """The stacked ViT and the unrolled one with the same weights
    (``unstack_scan_groups``): logits within 1e-5, and each depth slice
    of the stacked KFAC factors equals the unrolled layer's within 1e-5 of
    max."""
    scan, _, variables, _, _ = _pair("vit_scan")
    flat = tmodels.vit(32, 8, 32, 2, 4, 64, CLASSES, device="cpu")
    tmodels.load_jax_variables(flat, tmodels.unstack_scan_groups(variables,
                                                                 scan))
    x = _nchw(_images(3, 32, 6))
    with torch.no_grad():
        _close(scan(x), flat(x), 1e-5, "scan vs unrolled")
    labels = torch.tensor([[1, 2, 3]])
    es = port_est.KFAC(scan, attention_qkv_split=True)
    ef = port_est.KFAC(flat, attention_qkv_split=True)
    es.update(x, labels=labels)
    ef.update(x, labels=labels)
    for n, m in es.metas.items():
        if not m.stacked:
            continue
        rest = n[len("encoder.layers"):]
        for i in range(m.stacked):
            per = f"encoder.layers.encoder_layer_{i}{rest}"
            for key in ("a", "g"):
                _close(es.state[n][key][i], ef.state[per][key], 1e-5,
                       f"{per} {key}")


def test_vit_linearized_predictive_runs():
    """``torch.func.jvp`` through the ViT (explicit softmax attention):
    the linearized ensemble of a qkv-split KFAC posterior gives finite
    logits, and a zero offset gives the MAP logits back exactly."""
    tm, _, _, _, _ = _pair("vit")
    x = _nchw(_images(2, 32, 8))
    est = port_est.KFAC(tm, attention_qkv_split=True)
    est.update(x, labels=torch.tensor([[0, 1]]))
    est.invert(1.0, 10.0)
    ens = est.ensemble_params(2, generator=torch.Generator().manual_seed(0))
    fwd = make_linearized_ensemble_fn(tm)
    logits0, logits_s = fwd(est.mean_params, ens + [est.mean_params], x)
    assert logits_s.shape == (3, 2, CLASSES)
    assert torch.isfinite(logits_s).all()
    assert torch.equal(logits_s[-1], logits0)


# -- torchvision checkpoints ------------------------------------------------

def _torch_model(name):
    torch.manual_seed(0)
    if name == "vit":
        return TorchViT(image_size=32, patch_size=8, dim=64, depth=2,
                        heads=2, mlp_dim=128, num_classes=CLASSES), \
            tmodels.vit(32, 8, 64, 2, 2, 128, CLASSES, device="cpu"), 32
    if name == "vit_scan":
        return TorchViT(image_size=32, patch_size=8, dim=64, depth=2,
                        heads=2, mlp_dim=128, num_classes=CLASSES), \
            tmodels.vit(32, 8, 64, 2, 2, 128, CLASSES, scan_blocks=True,
                        device="cpu"), 32
    if name == "swin_t":
        return TorchSwin(num_classes=CLASSES), \
            tmodels.build("swin_t", CLASSES, device="cpu"), 56
    if name == "swin_v2_t":
        return TorchSwinV2(num_classes=CLASSES), \
            tmodels.build("swin_v2_t", CLASSES, device="cpu"), 48
    return TorchMaxVit(stem=8, channels=(8, 16), layers=(1, 1), head_dim=4,
                       partition=2, input_size=32, num_classes=CLASSES), \
        tmodels.maxvit(**MAXVIT_SMALL, num_classes=CLASSES,
                       device="cpu"), 32


@pytest.mark.parametrize("name", ["vit", "vit_scan", "swin_t", "swin_v2_t",
                                  "maxvit"])
def test_pth_round_trip(name, tmp_path):
    """A torchvision-layout ``.pth`` (packed ``in_proj_weight``, the raw
    tensors and index buffers, BatchNorm statistics; per-depth blocks
    into a stacked ViT) loads into the port with the torch model's
    logits within 1e-5 of max, and the port's state exported back loads
    into the torch model strictly with the same logits."""
    torch_model, port, size = _torch_model(name)
    torch_model.eval()
    for m in torch_model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.8, 1.2)
    path = str(tmp_path / "model.pth")
    torch.save(torch_model.state_dict(), path)
    variables = tmodels.load_torch_checkpoint(path, port)
    tmodels.load_jax_variables(port, variables)
    port.eval()
    x = _nchw(_images(2, size, 9))
    with torch.no_grad():
        want = torch_model(x)
        _close(port(x), want, 1e-5, f"{name} .pth logits")
    if name == "vit_scan":
        return
    out = tmodels.export_torch_state_dict(port.state_dict())
    if name == "vit":
        assert "encoder.layers.encoder_layer_0.self_attention.in_proj_weight" \
            in out
    fresh, _, _ = _torch_model(name)
    fresh.load_state_dict(out, strict=True)
    fresh.eval()
    with torch.no_grad():
        _close(fresh(x), want, 1e-6, f"{name} exported logits")


def test_packed_attention_conversion_raises_like_jax():
    """A bias-free or unpacked ``nn.MultiheadAttention`` raises, naming
    the layer, as JAX's converter does."""
    with pytest.raises(ValueError, match="attn: bias-free Multihead"):
        tmodels.convert_torch_state_dict(
            {"attn.in_proj_weight": torch.ones(12, 4)})
    with pytest.raises(ValueError, match="unpacked attention"):
        tmodels.convert_torch_state_dict(
            {"attn.q_proj_weight": torch.ones(4, 4)})
    sd = tmodels.convert_torch_state_dict(
        {"attn.in_proj_weight": torch.ones(12, 4),
         "attn.in_proj_bias": torch.zeros(12)})
    assert set(sd) == {"attn.in_proj.weight", "attn.in_proj.bias"}


# -- MaxViT-T's routes at 224² ----------------------------------------------

def test_maxvit_t_routes_match_jax():
    """``KFAC.a_route`` on MaxViT-T's layers at 224², B=16 (a meta-device
    forward) equals JAX's dispatch on its abstract capture: ``stem.1.0``
    (3x3 s1, C=64 at 112x112) is the one ``'tiled'`` layer in f32 and no
    layer takes a kernel in bf16; the depthwise convs are ``'grouped'``."""
    with torch.device("meta"):
        tm = tmodels.build("maxvit_t", 1000, device="meta")
    te = port_est.KFAC(tm, use_kernels=True)
    ctx = Context(track=te.metas, probes=False)
    tm.eval()
    tm(torch.empty((16, 3, 224, 224), device="meta"), ctx)
    jm = jmodels.build("maxvit_t", 1000)
    abstract = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32)))
    acts = jax.eval_shape(
        lambda v, x: jm.apply(v, x, capture=True)[1]["acts"], abstract,
        jax.ShapeDtypeStruct((16, 224, 224, 3), jnp.float32))
    for itemsize, tiled in ((4, ["stem.1.0"]), (2, [])):
        got = {n: te.a_route(m, ctx.acts[n].shape, itemsize)
               for n, m in te.metas.items()}
        for n, m in jm.metas.items():
            assert tuple(ctx.acts[n].shape) == tuple(acts[n].shape), n
            if m.kind != "conv" or m.groups > 1:
                continue
            shape = acts[n].shape
            want = select_patch_gram(shape[-1], m.kernel_size, m.strides,
                                     shape[1], shape[2], shape[0], itemsize)
            assert got[n] == (want or "patches"), (n, itemsize)
        assert [n for n, r in got.items() if r == "tiled"] == tiled
        assert not [n for n, r in got.items() if r == "v2"]
        assert got["blocks.0.layers.0.layers.MBconv.layers.conv_b.0"] \
            == "grouped"
    assert select_patch_gram(64, (3, 3), (1, 1), 112, 112, 16, 4) == "tiled"


# -- the CLIs -----------------------------------------------------------------

def _argv(tmp_path, *flags):
    return ["--platform", "cpu", "--model", "vit_b_16", "--data",
            "synthetic", "--root_dir", str(tmp_path), "--results_dir",
            str(tmp_path), "--layers",
            "encoder.layers.encoder_layer_11.*,heads.head"] + list(flags)


@pytest.mark.parametrize("flag,shape", [
    ("--qkv_split", (3, 768, 768)), ("--head_split", (3, 12, 64, 64))])
def test_cli_split_flags_reach_kfac(flag, shape, tmp_path, monkeypatch):
    """``factors --model vit_b_16 --data synthetic`` builds the ViT at the
    dataset's 32² (a 2x2 patch grid and the class token) and writes the
    split in_proj G ([3, 768, 768] with ``--qkv_split``, [3, 12, 64, 64]
    with ``--head_split``, JAX tests/test_pipelines.py:339-370);
    ``evaluate`` reads it back into a KFAC with the same split."""
    cfg = tconfig.setup(_argv(tmp_path, flag))
    model = tcommon.build_model(cfg)
    assert tuple(model.encoder.pos_embedding.shape) == (1, 5, 768)
    monkeypatch.setattr(tfactors, "build_data", _few_batches(
        tcommon.build_data))
    tfactors.main(_argv(tmp_path, flag, "--estimator", "kfac"))
    state = tckpt.load_pytree(tckpt.factors_path(cfg, "kfac"))
    name = "encoder.layers.encoder_layer_11.self_attention/in_proj"
    assert state[name]["g"].shape == shape
    assert state[name]["a"].shape == (769, 769)
    if flag == "--head_split":
        out = "encoder.layers.encoder_layer_11.self_attention/out_proj"
        assert state[out]["a"].shape == (12, 64, 64)
        assert float(state[out]["a_bias"]) > 0
    est = tevaluate.load_estimator(tconfig.parse_args(
        _argv(tmp_path, flag, "--estimator", "kfac")), model)
    assert est.attention_qkv_split == (flag == "--qkv_split")
    assert est.attention_head_split == (flag == "--head_split")
    est.invert(1.0, 1e4)
    assert torch.isfinite(est.sample(generator=torch.Generator()
                                     .manual_seed(0))[name]).all()


def _few_batches(build_data):
    """The synthetic train split cut to two batches (the CLI's loop, not
    its length, is under test)."""
    def build(cfg, splits="train"):
        data = build_data(cfg, splits)
        if splits != "train":
            return data
        return [b for _, b in zip(range(2), data)]
    return build


def test_cli_builds_every_transformer_and_moe_still_raises(tmp_path):
    """``models.build`` constructs every ViT, Swin and MaxViT name of the
    JAX registry (on the meta device: no weights); ``build_model`` sizes
    MaxViT's partition by the input (32² -> 1, JAX :75-79). The MoE GPT-2
    no longer raises since it is ported: ``--model gpt2_moe_tiny`` sets
    up, and ``models.build`` makes it with JAX's metas."""
    for name in ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14",
                 "swin_t", "swin_s", "swin_b", "swin_v2_t", "swin_v2_s",
                 "swin_v2_b", "maxvit_t"):
        with torch.device("meta"):
            m = tmodels.build(name, 7, device="meta")
        jm = jmodels.build(name, 7)
        assert len(m.metas) > 10, name
        assert type(jm).__name__ == "Model", name
    cfg = tconfig.setup(["--platform", "cpu", "--model", "maxvit_t",
                         "--data", "synthetic", "--root_dir", str(tmp_path)])
    m = tcommon.build_model(cfg)
    attn = dict(m.named_modules())[
        "blocks.0.layers.0.layers.window_attention"]
    assert attn.partition == 1
    cfg = tconfig.setup(["--platform", "cpu", "--model", "gpt2_moe_tiny",
                         "--data", "tokens"])
    assert cfg.model == "gpt2_moe_tiny"
    moe = tmodels.build("gpt2_moe_tiny", 10, device="cpu", max_len=8)
    jmoe = jmodels.build("gpt2_moe_tiny", 10, max_len=8)
    jax.eval_shape(lambda: jmoe.init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32)))
    assert list(moe.metas) == list(jmoe.metas)
    assert {n: (m.stacked, m.moe) for n, m in moe.metas.items()} == \
        {n: (m.stacked, m.moe) for n, m in jmoe.metas.items()}
