"""Attention in the port against the JAX package: ``nn.MultiheadAttention``
and KFAC's ``attention_qkv_split`` and ``attention_head_split``.

Two models get the same seeded numpy weights in both packages
(``models.seeded_variables``), the same numpy-seeded inputs and the same
injected labels: ``tiny_transformer`` (dim 8, 2 heads, 1 layer, inputs
``[B, T, 8]``, JAX tests/test_estimators.py:409-530) and
``transformer_encoder`` (vocabulary 50, dim 16, 2 heads, depth 2, int
tokens). For each of no split, the qkv split and the head split: every A
and G block element-wise against JAX, the split G blocks against the
unsplit factor's diagonal blocks, the damped inverse Choleskys, samples
from JAX's own standard-normal draws, the logdet (and the evidence over
it, JAX tests/test_marglik.py:186), and the refusals (``quad``/``solve``,
the optimizer, EFB and INF). Each test states its tolerance, relative to
the largest magnitude of the JAX value.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.eval import marglik as jml
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch import optim as toptim
from curvature_tpu_torch.eval import marglik as tml

torch.set_num_threads(1)

ADD, MULTIPLY = 1.0, 50.0
SPLITS = {"plain": {}, "qkv": {"attention_qkv_split": True},
          "head": {"attention_head_split": True}}


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


def _models(which):
    """(port model, JAX model, variables, port input, JAX input)."""
    rng = np.random.default_rng(3)
    if which == "tiny":
        tm = tmodels.tiny_transformer(8, 2, 1, 4, device="cpu")
        jm = jmodels.tiny_transformer(vocab_free_dim=8, num_heads=2,
                                      num_layers=1, num_classes=4)
        x = rng.standard_normal((4, 5, 8)).astype(np.float32)
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
    else:
        tm = tmodels.transformer_encoder(vocab=50, dim=16, heads=2, depth=2,
                                         max_len=12, num_classes=5,
                                         device="cpu")
        jm = jmodels.transformer_encoder(vocab=50, dim=16, heads=2, depth=2,
                                         max_len=12, num_classes=5)
        x = rng.integers(0, 50, (4, 9)).astype(np.int32)
        tx, jx = torch.from_numpy(x).long(), jnp.asarray(x)
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jx))
    return tm, jm, variables, tx, jx


@pytest.fixture(scope="module", params=["tiny", "encoder"])
def built(request):
    return (request.param,) + _models(request.param)


def test_layers_heads_and_variables_match_jax(built):
    which, tm, jm, variables, tx, jx = built
    assert list(tm.metas) == list(jm.metas)
    for name, m in jm.metas.items():
        t = tm.metas[name]
        assert (t.kind, t.out_features, t.fan_in, t.has_bias, t.heads) == \
            (m.kind, m.out_features, m.fan_in, m.has_bias, m.heads), name
    attn = [n for n in jm.metas if n.endswith(("/in_proj", "/out_proj"))]
    assert len(attn) == (2 if which == "tiny" else 4)
    assert all(tm.metas[n].heads == 2 for n in attn)
    jvars = jm.init(jax.random.PRNGKey(0), jx)
    assert set(jvars["params"]) == set(variables["params"])
    for layer, group in jvars["params"].items():
        for k, arr in group.items():
            assert variables["params"][layer][k].shape == arr.shape, layer
    # the round trip through the state dict keeps JAX's names
    again = tmodels.variables_to_jax(tm)
    assert set(again["params"]) == set(variables["params"])


def test_logits_match_jax(built):
    """1e-5 of max|logits|."""
    _, tm, jm, variables, tx, jx = built
    want, _ = jm.apply(_jv(variables), jx, train=False)
    with torch.no_grad():
        got = tm(tx)
    _close(got, want, 1e-5, "logits")


def test_mha_alone_matches_jax():
    """One ``nn.MultiheadAttention`` (dim 8, 2 heads) as a whole model in
    both packages, the same seeded weights: outputs within 1e-5 of max;
    meta names ``<name>/in_proj``, module paths ``<name>.in_proj``."""
    from curvature_tpu import nn as jnn
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    jm = jnn.Model(jnn.MultiheadAttention(8, 2, name="attn"))
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert set(jv["params"]) == {"attn/in_proj", "attn/out_proj"}
    assert jm.metas["attn/in_proj"].heads == 2
    mha = tnn.MultiheadAttention(8, 2, name="attn")
    assert (mha.in_proj.name, mha.out_proj.name) == ("attn/in_proj",
                                                    "attn/out_proj")
    assert mha.in_proj.meta.heads == mha.out_proj.meta.heads == 2
    params = {}
    for layer in ("in_proj", "out_proj"):
        w = rng.standard_normal(tuple(getattr(mha, layer).weight.shape))
        b = rng.standard_normal(tuple(getattr(mha, layer).bias.shape))
        params[f"attn/{layer}"] = {"kernel": w.T.astype(np.float32),
                                   "bias": b.astype(np.float32)}
        getattr(mha, layer).weight.data = torch.from_numpy(
            w.astype(np.float32))
        getattr(mha, layer).bias.data = torch.from_numpy(b.astype(np.float32))
    want, _ = jm.apply(_jv({"params": params, "batch_stats": {}}),
                       jnp.asarray(x), train=False)
    with torch.no_grad():
        got = mha(torch.from_numpy(x))
    _close(got, want, 1e-5, "attention output")


def _pair(which, split, layer_filter=None):
    """JAX and port KFAC updated on the same batch with the same labels."""
    tm, jm, variables, tx, jx = _models(which)
    labels = np.random.default_rng(7).integers(
        0, 4 if which == "tiny" else 5, (2, tx.shape[0])).astype(np.int32)
    kw = dict(SPLITS[split], layer_filter=layer_filter)
    je = jest.KFAC(jm, _jv(variables), use_pallas=False, **kw)
    te = port_est.KFAC(tm, **kw)
    je.update(jx, labels=jnp.asarray(labels))
    te.update(tx, labels=torch.from_numpy(labels))
    return dict(je=je, te=te, tm=tm, jm=jm, variables=variables, tx=tx,
                jx=jx, labels=labels)


@pytest.fixture(scope="module", params=[
    (w, s) for w in ("tiny", "encoder") for s in SPLITS],
    ids=lambda p: f"{p[0]}-{p[1]}")
def fitted(request):
    which, split = request.param
    out = _pair(which, split)
    out["je"].invert(ADD, MULTIPLY)
    out["te"].invert(ADD, MULTIPLY)
    return dict(out, which=which, split=split)


_SHAPES = {
    "qkv": {"in": lambda e, h: {"g": (3, e, e), "a": (e + 1, e + 1)}},
    "head": {"in": lambda e, h: {"g": (3, h, e // h, e // h),
                                 "a": (e + 1, e + 1)},
             "out": lambda e, h: {"a": (h, e // h, e // h), "g": (e, e),
                                  "a_bias": ()}},
}


def test_factors_match_jax(fitted):
    """A and every G block within 1e-4 of max of JAX's; the split layouts
    have JAX's shapes and keys."""
    je, te = fitted["je"], fitted["te"]
    for name, meta in je.metas.items():
        assert set(te.state[name]) == set(je.state[name]), name
        for key in je.state[name]:
            _close(te.state[name][key], je.state[name][key], 1e-4,
                   f"{name} {key}")
        kind = ("in" if name.endswith("/in_proj") else
                "out" if name.endswith("/out_proj") else None)
        want = _SHAPES.get(fitted["split"], {}).get(kind)
        if want is not None:
            shapes = want(meta.fan_in if kind == "in" else meta.out_features,
                          meta.heads)
            for key, shape in shapes.items():
                assert tuple(te.state[name][key].shape) == shape, (name, key)


@pytest.mark.parametrize("which", ["tiny", "encoder"])
@pytest.mark.parametrize("split", ["qkv", "head"])
def test_split_g_blocks_are_the_unsplit_diagonal_blocks(which, split):
    """A split in_proj G equals the unsplit [3E, 3E] G's diagonal blocks
    (per chunk, per head) within 1e-6 of max; a head-split out_proj's A
    the unsplit A's per-head diagonal blocks, its bias block the count of
    MC samples, its G the unsplit G."""
    plain = _pair(which, "plain")["te"]
    te = _pair(which, split)["te"]
    for name, meta in te.metas.items():
        full, fac = plain.state[name], te.state[name]
        if name.endswith("/in_proj"):
            e = meta.out_features // 3
            for k in range(3):
                blk = full["g"][k * e:(k + 1) * e, k * e:(k + 1) * e]
                if split == "qkv":
                    _close(fac["g"][k], blk, 1e-6, f"{name} chunk {k}")
                else:
                    d = e // meta.heads
                    for h in range(meta.heads):
                        _close(fac["g"][k, h],
                               blk[h * d:(h + 1) * d, h * d:(h + 1) * d],
                               1e-6, f"{name} chunk {k} head {h}")
            _close(fac["a"], full["a"], 1e-6, f"{name} shared A")
        elif name.endswith("/out_proj") and split == "head":
            d = meta.fan_in // meta.heads
            for h in range(meta.heads):
                _close(fac["a"][h], full["a"][h * d:(h + 1) * d,
                                              h * d:(h + 1) * d],
                       1e-6, f"{name} head {h}")
            assert float(fac["a_bias"]) == float(full["a"][-1, -1]) == 2.0
            _close(fac["g"], full["g"], 1e-6, f"{name} G")
        else:
            for key in ("a", "g"):
                _close(fac[key], full[key], 1e-6, f"{name} {key}")


def test_inverse_choleskys_match_jax(fitted):
    """1e-4 of max (the bias block's scalar too)."""
    je, te = fitted["je"], fitted["te"]
    for name in je.metas:
        assert set(te.inv_state[name]) == set(je.inv_state[name]), name
        for key, want in je.inv_state[name].items():
            _close(te.inv_state[name][key], want, 1e-4, f"{name} {key}")


def _jax_noise(te, seed):
    """JAX's draws (kfac.py:786-850): one key per layer split off in meta
    order, ``normal(key, shape)``; a head-split out_proj splits its key
    once more, the weights' draw from the first half and the bias
    column's from the second."""
    rng = jax.random.PRNGKey(seed)
    noise = {}
    for name, shape in te.noise_shapes().items():
        rng, key = jax.random.split(rng)
        if isinstance(shape, dict):
            key, kb = jax.random.split(key)
            noise[name] = {"z": np.array(jax.random.normal(
                key, shape["z"], jnp.float32))}
            if "bias" in shape:
                noise[name]["bias"] = np.array(jax.random.normal(
                    kb, shape["bias"], jnp.float32))
        else:
            noise[name] = np.array(jax.random.normal(key, shape,
                                                     jnp.float32))
    return noise


def test_samples_match_jax_with_the_same_draws(fitted):
    """5e-4 of max (tests/test_torch_kfac.py's bar): a block or head laid
    out in the wrong rows would still look like a valid sample; only the
    element-wise comparison catches it."""
    je, te = fitted["je"], fitted["te"]
    want = je.sample(jax.random.PRNGKey(5))
    got = te.sample(noise=_jax_noise(te, 5))
    for name, meta in je.metas.items():
        assert tuple(got[name].shape) == (meta.out_features, meta.mat_cols)
        _close(got[name], want[name], 5e-4, f"{name} sample")
    # and a draw of the port's own is finite and of the same layout
    own = te.sample(generator=torch.Generator().manual_seed(0))
    for name in je.metas:
        assert own[name].shape == got[name].shape
        assert torch.isfinite(own[name]).all()


def test_logdet_matches_jax(fitted):
    """1e-5 relative."""
    je, te = fitted["je"], fitted["te"]
    want = je.logdet_precision(ADD, MULTIPLY)
    got = te.logdet_precision(ADD, MULTIPLY)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _dense_damped(f):
    f = np.asarray(f, np.float64)
    return math.sqrt(MULTIPLY) * (f + f.T) / 2 \
        + math.sqrt(ADD) * np.eye(f.shape[0])


def _block_logdets(fac):
    """Sum of slogdets over the layer's Kronecker blocks, in float64
    (JAX tests/test_marglik.py:186-218)."""
    a, g = np.asarray(fac["a"]), np.asarray(fac["g"])
    if a.ndim == 2 and g.ndim == 2:
        return np.linalg.slogdet(np.kron(_dense_damped(a),
                                         _dense_damped(g)))[1]
    tot = 0.0
    if "a_bias" in fac:
        gd = _dense_damped(g)
        for ah in a:
            tot += np.linalg.slogdet(np.kron(_dense_damped(ah), gd))[1]
        rb = math.sqrt(MULTIPLY) * float(fac["a_bias"]) + math.sqrt(ADD)
        return tot + np.linalg.slogdet(rb * gd)[1]
    ad = _dense_damped(a)
    for gb in g.reshape((-1,) + g.shape[-2:]):
        tot += np.linalg.slogdet(np.kron(ad, _dense_damped(gb)))[1]
    return tot


def test_logdet_is_the_dense_block_sum(fitted):
    """The port's logdet equals the float64 slogdet summed over the dense
    Kronecker blocks, 1e-4 relative (JAX's bar for the same check)."""
    te = fitted["te"]
    want = sum(_block_logdets({k: _np(v) for k, v in fac.items()})
               for fac in te.state.values())
    np.testing.assert_allclose(te.logdet_precision(ADD, MULTIPLY), want,
                               rtol=1e-4)


def test_evidence_over_split_factors_matches_jax(fitted):
    """The Laplace evidence through ``logdet_state`` (JAX
    tests/test_marglik.py:186) within 1e-5 relative of JAX's, and its
    autograd gradient in log-damping finite."""
    je, te = fitted["je"], fitted["te"]
    want = jml.log_marginal_likelihood(je, 3.0, ADD, MULTIPLY)
    got = tml.log_marginal_likelihood(te, 3.0, ADD, MULTIPLY)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    res = tml.marglik_gradient_tune(te, 3.0, steps=3)
    assert np.isfinite(res["log_marglik"]) and all(
        np.isfinite(v) for v in res["trace"])


def test_quad_and_solve_raise_for_splits_as_jax(fitted):
    """Split factors are a posterior layout: ``quadratic_form`` raises
    NotImplementedError and ``precision_solve`` ValueError in both
    packages; unsplit factors run both (within 1e-4 of JAX)."""
    je, te = fitted["je"], fitted["te"]
    rng = np.random.default_rng(11)
    deltas = {n: rng.standard_normal((m.out_features, m.mat_cols))
              .astype(np.float32) for n, m in je.metas.items()}
    if fitted["split"] == "plain":
        want = je.quadratic_form(deltas, ADD, MULTIPLY)
        got = te.quadratic_form(deltas, ADD, MULTIPLY)
        assert abs(got - want) <= 1e-4 * abs(want)
        want = je.precision_solve(deltas, ADD, MULTIPLY)
        got = te.precision_solve(deltas, ADD, MULTIPLY)
        for name in je.metas:
            _close(got[name], want[name], 1e-4, f"{name} solve")
        return
    with pytest.raises(NotImplementedError, match="split attention"):
        je.quadratic_form(deltas, ADD, MULTIPLY)
    with pytest.raises(NotImplementedError, match="split attention"):
        te.quadratic_form(deltas, ADD, MULTIPLY)
    with pytest.raises(ValueError, match="posterior-only"):
        je.precision_solve(deltas, ADD, MULTIPLY)
    with pytest.raises(ValueError, match="posterior-only"):
        te.precision_solve(deltas, ADD, MULTIPLY)


@pytest.mark.parametrize("split", ["qkv", "head"])
def test_efb_inf_and_the_optimizer_reject_split_factors(split):
    """EFB and INF need square factors (JAX efb.py, inf.py:252-255), the
    KFAC optimizer's preconditioner plain ones: each raises ValueError
    on split attention factors, naming them."""
    out = _pair("tiny", split)
    te, tm = out["te"], out["tm"]
    with pytest.raises(ValueError, match="split KFAC factors"):
        port_est.EFB(tm, te.state)
    diags = {n: torch.ones(m.out_features, m.mat_cols)
             for n, m in te.metas.items()}
    lambdas = {n: torch.ones(m.out_features, m.mat_cols)
               for n, m in te.metas.items()}
    with pytest.raises(ValueError, match="split KFAC factors"):
        port_est.INF(tm, diags, te.state, lambdas)
    te.invert(ADD, MULTIPLY)
    grads = {k: torch.zeros_like(v) for k, v in tm.state_dict().items()}
    with pytest.raises(ValueError, match="posterior-only"):
        toptim.precondition(te.metas, te.inv_state, grads)
    # JAX refuses the same factors
    with pytest.raises(ValueError, match="split KFAC factors"):
        jest.EFB(out["jm"], _jv(out["variables"]), out["je"].state)


def test_posterior_params_reach_the_attention_weights():
    """A head-split sample lands on the module's own state-dict keys
    (``block0.attn.in_proj.weight``, ``.out_proj.bias``) through
    ``nn.core.param_key``, and the model runs on it."""
    out = _pair("tiny", "head")
    te, tm = out["te"], out["tm"]
    te.invert(ADD, MULTIPLY)
    params = te.posterior_params(generator=torch.Generator().manual_seed(1))
    for key in ("block0.attn.in_proj.weight", "block0.attn.in_proj.bias",
                "block0.attn.out_proj.weight", "block0.attn.out_proj.bias"):
        assert key in params
        assert not torch.equal(params[key], te.mean_params[key]), key
    logits = torch.func.functional_call(tm, params, (out["tx"],))
    assert torch.isfinite(logits).all()


def test_stacked_head_split_matches_jax():
    """The head and qkv splits on a depth-stacked layer carry the depth
    axis first ([depth, 3, H, d, d] G, [depth, H, d, d] A, [depth]
    a_bias): on a scanned ViT (dim 32, 4 heads, depth 2, 16² with 8²
    patches) every factor within 1e-4 of max of JAX's, invert 1e-4,
    samples from JAX's draws 5e-4, logdet 1e-5 relative."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 6, (1, 2)).astype(np.int32)
    tm = tmodels.vit(16, 8, 32, 2, 4, 64, 6, scan_blocks=True, device="cpu")
    jm = jmodels.vit(16, 8, 32, 2, 4, 64, 6, scan_blocks=True)
    variables = tmodels.seeded_variables(tm, 2)
    tmodels.load_jax_variables(tm, variables)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    for kw in SPLITS.values():
        je = jest.KFAC(jm, _jv(variables), use_pallas=False, **kw)
        te = port_est.KFAC(tm, **kw)
        je.update(jnp.asarray(x), labels=jnp.asarray(labels))
        te.update(tx, labels=torch.from_numpy(labels))
        for name in je.metas:
            for key in je.state[name]:
                _close(te.state[name][key], je.state[name][key], 1e-4,
                       f"{kw} {name} {key}")
        name = "encoder.layers.self_attention/in_proj"
        if kw.get("attention_head_split"):
            assert tuple(te.state[name]["g"].shape) == (2, 3, 4, 8, 8)
            out_name = "encoder.layers.self_attention/out_proj"
            assert tuple(te.state[out_name]["a"].shape) == (2, 4, 8, 8)
            assert tuple(te.state[out_name]["a_bias"].shape) == (2,)
        je.invert(ADD, MULTIPLY)
        te.invert(ADD, MULTIPLY)
        for name in je.metas:
            for key, want in je.inv_state[name].items():
                _close(te.inv_state[name][key], want, 1e-4,
                       f"{kw} {name} {key}")
        want = je.sample(jax.random.PRNGKey(9))
        got = te.sample(noise=_jax_noise(te, 9))
        for name in je.metas:
            _close(got[name], want[name], 5e-4, f"{kw} {name} sample")
        w, g = je.logdet_precision(ADD, MULTIPLY), \
            te.logdet_precision(ADD, MULTIPLY)
        assert abs(g - w) <= 1e-5 * abs(w), (kw, g, w)
