"""KFAC's constructor options against the JAX estimator's
(curvature_tpu/estimators/kfac.py:80-203): ``corr_gram`` switches the
correlation route off, ``corr_gram_min_channels`` is accepted and moves
the gate, ``max_factor_dim`` raises with JAX's message before any factor
exists, ``stack_grams`` batches the Grams across layers and ``fused_g``
reduces the output gradients to their Grams in the backward: both give
JAX's factors with the same option and the port's without it, within
1e-5 of max, and ``gram_probe_names`` is JAX's set."""
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
from curvature_tpu_torch.estimators import grams as tgrams
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


# -- stack_grams and fused_g -------------------------------------------------

def _states_close(got, want, what, rel=1e-5):
    for name in want:
        for key in want[name]:
            w = np.asarray(want[name][key])
            g = got[name][key]
            g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
            np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(),
                                       err_msg=f"{what} {name}.{key}")


def _kfac_pair(tm, jm, jv, tx, jx, labels, **kw):
    """(port state with ``kw``, JAX state with ``kw``, port state without
    the options) after one update on the same labels."""
    base = {k: v for k, v in kw.items()
            if k not in ("stack_grams", "fused_g")}
    jkw = {k: v for k, v in kw.items() if k != "use_kernels"}
    te = port_est.KFAC(tm, **kw)
    te.update(tx, labels=torch.from_numpy(labels))
    je = jest.KFAC(jm, jv, **jkw)
    je.update(jx, labels=jnp.asarray(labels))
    td = port_est.KFAC(tm, **base)
    td.update(tx, labels=torch.from_numpy(labels))
    return te, je, td


def _conv_net_pair():
    """JAX tests/test_corr_gram.py:103-129's net (stride-1 3x3, strided
    3x3, 1x1, fc) in both packages with the same seeded weights."""
    tm = tnn.Sequential([
        tnn.Conv(3, 8, 3, padding=1, name="c1"), tnn.ReLU(),
        tnn.Conv(8, 8, 3, stride=2, padding=1, name="c2"), tnn.ReLU(),
        tnn.Conv(8, 8, 1, name="c3"), tnn.ReLU(), tnn.Flatten(),
        tnn.Dense(8 * 4 * 4, 5, name="fc")])
    variables = tmodels.seeded_variables(tm, 3)
    tmodels.load_jax_variables(tm, variables)
    jm = jnn.Model(jnn.Sequential([
        jnn.Conv(8, 3, padding=1, name="c1"), jnn.ReLU(),
        jnn.Conv(8, 3, strides=2, padding=1, name="c2"), jnn.ReLU(),
        jnn.Conv(8, 1, name="c3"), jnn.ReLU(), jnn.Flatten(),
        jnn.Dense(5, name="fc")]))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 4)).astype(np.int32)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    return tm, jm, jv, tx, jnp.asarray(x), labels


def _gpt_pair(scan=False):
    """An unrolled (or stacked) small GPT-2, seeded weights, [4, 8]
    tokens and [2, 4, 8] labels."""
    tm = tmodels.gpt2_custom(32, 16, 2, 2, 8, scan_blocks=scan, device="cpu")
    variables = tmodels.seeded_variables(tm, 5)
    tmodels.load_jax_variables(tm, variables)
    jm = jmodels.gpt2_custom(32, 16, 2, 2, 8, scan_blocks=scan)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(6)
    tok = rng.integers(0, 32, (4, 8)).astype(np.int32)
    labels = rng.integers(0, 32, (2, 4, 8)).astype(np.int32)
    return tm, jm, jax.tree_util.tree_map(jnp.asarray, variables), \
        torch.from_numpy(tok), jnp.asarray(tok), labels


@pytest.mark.parametrize("opts", [{"stack_grams": True},
                                  {"stack_grams": True, "fused_g": True}],
                         ids=["stack", "stack+fused"])
@pytest.mark.parametrize("net", ["conv", "gpt2"])
def test_stack_grams_matches_jax_and_the_default(net, opts, monkeypatch):
    """``stack_grams`` (JAX test_corr_gram.py:223, its conv net with
    ``corr_gram=False``; an unrolled GPT-2, whose same-width projections
    share their token shapes) gives JAX's factors and the port's
    per-layer ones; the batched buckets really form."""
    if net == "conv":
        tm, jm, jv, tx, jx, labels = _conv_net_pair()
        kw = dict(corr_gram=False, use_kernels=False)
        want_g = {"c2", "c3"}
    else:
        tm, jm, jv, tx, jx, labels = _gpt_pair()
        kw = dict(loss="lm", use_kernels=False)
        want_g = {"h.0.attn.c_proj", "h.0.mlp.c_proj", "h.1.attn.c_proj",
                  "h.1.mlp.c_proj", "h.0.attn.c_attn", "h.1.attn.c_attn",
                  "h.0.mlp.c_fc", "h.1.mlp.c_fc"}
    seen = {}
    stacked = tkfac.KFAC._stacked_grams

    def spy(self, cap, grams):
        pre_a, pre_g = stacked(self, cap, grams)
        seen.update(a=set(pre_a), g=set(pre_g))
        return pre_a, pre_g
    monkeypatch.setattr(tkfac.KFAC, "_stacked_grams", spy)
    te, je, td = _kfac_pair(tm, jm, jv, tx, jx, labels, **kw, **opts)
    _states_close(te.state, je.state, "vs JAX")
    _states_close(te.state, td.state, "vs the default")
    if opts.get("fused_g"):
        assert not seen["g"] & te.gram_probe_names
    else:
        assert seen["g"] == want_g
        assert net == "conv" or len(seen["a"]) == 8


@pytest.mark.parametrize("net", ["mlp", "lenet5", "gpt2", "gpt2_scan"])
def test_fused_g_matches_jax_and_the_default(net):
    """``fused_g`` (JAX test_estimators.py:593-638): the MLP, LeNet-5 on a
    channels_last input (NCHW output gradients, the channel axis moved
    last before the Gram), an unrolled causal LM and a stacked one (whose
    stacked layers keep their probes): JAX's factors and the default's."""
    rng = np.random.default_rng(7)
    if net == "mlp":
        tm = tmodels.mlp((7,), 4, in_features=5, device="cpu")
        jm = jmodels.mlp([7], 4)
        x = rng.standard_normal((16, 5)).astype(np.float32)
        labels = rng.integers(0, 4, (2, 16)).astype(np.int32)
        tx = torch.from_numpy(x)
        kw = {}
    elif net == "lenet5":
        tm = tmodels.lenet5(device="cpu")
        jm = jmodels.lenet5()
        x = rng.standard_normal((8, 28, 28, 1)).astype(np.float32)
        labels = rng.integers(0, 10, (2, 8)).astype(np.int32)
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        kw = {"use_kernels": False}
    if net in ("mlp", "lenet5"):
        variables = tmodels.seeded_variables(tm, 8)
        tmodels.load_jax_variables(tm, variables)
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
        jv = jax.tree_util.tree_map(jnp.asarray, variables)
        jx = jnp.asarray(x)
    else:
        tm, jm, jv, tx, jx, labels = _gpt_pair(scan=net == "gpt2_scan")
        kw = {"loss": "lm"}
    te, je, td = _kfac_pair(tm, jm, jv, tx, jx, labels, fused_g=True, **kw)
    want = ({"lm_head"} if net == "gpt2_scan" else set(te.metas))
    assert te.gram_probe_names == je.gram_probe_names == want
    _states_close(te.state, je.state, "vs JAX")
    _states_close(te.state, td.state, "vs the default")
    cap = te.capture(tx, labels=torch.from_numpy(labels))
    assert set(cap.probe_grams) == want and not want & set(cap.probe_grads)
    for name in want:
        assert cap.probe_grams[name].shape == (2,) + (
            te.metas[name].out_features,) * 2


def test_fused_g_excludes_subsampled_convs():
    """JAX test_estimators.py:640-660: under ``token_subsample < 1`` the
    convs keep their probes (a strided token grid needs the raw gradient)
    while the dense layers are fused, and the mixed capture still gives
    the default's factors and JAX's."""
    rng = np.random.default_rng(9)
    tm = tmodels.lenet5(device="cpu")
    jm = jmodels.lenet5()
    x = rng.standard_normal((8, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (1, 8)).astype(np.int32)
    variables = tmodels.seeded_variables(tm, 10)
    tmodels.load_jax_variables(tm, variables)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    te, je, td = _kfac_pair(tm, jm, jv, tx, jnp.asarray(x), labels,
                            fused_g=True, token_subsample=0.25)
    fused = te.gram_probe_names
    assert fused == je.gram_probe_names
    assert fused and all(te.metas[n].kind == "dense" for n in fused)
    _states_close(te.state, je.state, "vs JAX")
    _states_close(te.state, td.state, "vs the default")


def test_fused_capture_needs_probe_gradients():
    """JAX's ``ValueError`` when the taps are asked for without probe
    gradients (capture.py:171-173)."""
    from curvature_tpu_torch.estimators.capture import collect
    tm = tmodels.mlp((7,), 4, in_features=5, device="cpu")
    with pytest.raises(ValueError, match="requires need_probe_grads"):
        collect(tm, tm.metas, torch.zeros(2, 5), labels=torch.zeros(2),
                need_probe_grads=False, gram_probe_names={"fc1"})


class _JBlock(jnn.Module):
    def __init__(self, prefix):
        self.name = prefix
        self.fc = jnn.Dense(8, name=f"{prefix}.fc")

    def __call__(self, ctx, x):
        return self.fc(ctx, x)


class _JSeq(jnn.Module):
    """A depth-stacked Dense, an attention block and a wide head."""

    def __init__(self):
        self.name = None
        self.stack = jnn.ScanBlocks(lambda p: _JBlock(p), depth=2,
                                    name="blk")
        self.attn = jnn.MultiheadAttention(8, 2, name="attn")
        self.head = jnn.Dense(40, name="head")

    def __call__(self, ctx, x):
        return self.head(ctx, self.attn(ctx, self.stack(ctx, x)))


class _TBlock(tnn.CtxModule):
    def __init__(self, prefix):
        super().__init__()
        self.fc = tnn.Dense(8, 8, name=f"{prefix}.fc")

    def forward(self, x, ctx=None):
        return self.fc(x, ctx)


class _TSeq(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stack = tnn.ScanBlocks(lambda p: _TBlock(p), 2, "blk")
        self.attn = tnn.MultiheadAttention(8, 2, name="attn")
        self.head = tnn.Dense(8, 40, name="head")

    @property
    def metas(self):
        return {m.name: m.meta for m in self.modules() if tnn.is_tracked(m)}

    def forward(self, x, ctx=None):
        return self.head(self.attn(self.stack(x, ctx), ctx), ctx)


@pytest.mark.parametrize("kw", [{"attention_qkv_split": True},
                                {"attention_head_split": True},
                                {"token_subsample": 0.25}, {}],
                         ids=["qkv", "head", "sub4", "plain"])
def test_gram_probe_names_are_jax_set(kw):
    """The fused-G capture set leaves out stacked (ScanBlocks depth and
    MoE experts), grouped, qkv/head-split and blocked-G layers and
    subsampled convs, as JAX's (kfac.py:282-302): the same set on a
    sequence model (stacked Dense, attention, a head past
    ``max_factor_dim``: blocked G), a conv net with a grouped conv, and
    the MoE GPT-2."""
    seq = _TSeq()
    jseq = jnn.Model(_JSeq())
    jsv = jseq.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 8)))
    conv = tnn.Sequential([tnn.Conv(4, 8, 3, padding=1, name="c1"),
                           tnn.Conv(8, 8, 3, padding=1, groups=4, name="g1"),
                           tnn.Flatten(), tnn.Dense(8 * 6 * 6, 3, name="fc")])
    jconv = jnn.Model(jnn.Sequential([
        jnn.Conv(8, 3, padding=1, name="c1"),
        jnn.Conv(8, 3, padding=1, groups=4, name="g1"), jnn.Flatten(),
        jnn.Dense(3, name="fc")]))
    jcv = jconv.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 6, 4)))
    moe = tmodels.gpt2_moe_tiny(16, experts=2, max_len=4, device="cpu")
    jmoe = jmodels.gpt2_moe_tiny(16, experts=2, max_len=4)
    jmv = jmoe.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    got = {}
    for what, tm, jm, jv, extra in (
            ("seq", seq, jseq, jsv, dict(max_factor_dim=32,
                                         g_block_size=16)),
            ("conv", conv, jconv, jcv, {}), ("moe", moe, jmoe, jmv, {})):
        te = port_est.KFAC(tm, fused_g=True, use_kernels=False, **kw,
                           **extra)
        je = jest.KFAC(jm, jv, fused_g=True, **kw, **extra)
        assert te.gram_probe_names == je.gram_probe_names, what
        got[what] = te.gram_probe_names
        off = port_est.KFAC(tm, use_kernels=False, **kw, **extra)
        assert off.gram_probe_names == frozenset()
    assert got["moe"] == {"h.0.attn.c_attn", "h.0.attn.c_proj",
                          "h.1.attn.c_attn", "h.1.attn.c_proj", "lm_head"}
    assert got["conv"] == ({"fc"} if kw.get("token_subsample")
                           else {"c1", "fc"})


@pytest.mark.parametrize("shape", [(3, 5000, 17), (2, 700, 130),
                                   (1, 3000, 300)],
                         ids=["chunked", "one-chunk", "padded"])
def test_batched_gram_chunks_the_token_axis(shape):
    """The seam's batched matmul Gram (``grams.factor_gram`` off the
    kernel) cuts a long token axis into chunks (zero rows pad the last),
    and a wide column count (``padded``: 300, once zero-padded to 384)
    takes no pad: in float64 it equals each layer's own ``a^T a`` to
    rounding."""
    a = torch.from_numpy(np.random.default_rng(11).standard_normal(shape))
    want = torch.stack([t.T @ t for t in a])
    got = tgrams.factor_gram(a, torch.float64, False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=1e-12 * want.abs().max().item())
